"""Render session stats (copied from akari_render_tpu/stats.py, without
its dispatch profiler).

Reference: crates/akari_integrator/src/lib.rs:8-37 (RenderSession,
RenderStats/IntermediateStats — the `{session}.json` time/spp/path series
used for MSE-vs-time curves).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class RenderSession:
    """Mirrors RenderSession (lib.rs:8-23), without the per-pass EXR dumps
    and the live display, which are not ported."""

    name: str = "render"
    save_stats: bool = False
    out_dir: str = "."


@dataclass
class RenderStats:
    """The reference's stats-JSON format: intermediate = [{time, spp, path}]."""

    intermediate: list = field(default_factory=list)

    def record(self, t: float, spp: int, path: str = ""):
        self.intermediate.append({"time": t, "spp": spp, "path": path})

    def write(self, session: RenderSession):
        p = Path(session.out_dir) / f"{session.name}.json"
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps({"intermediate": self.intermediate}))
        return p

