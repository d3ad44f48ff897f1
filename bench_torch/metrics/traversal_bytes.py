"""The compulsory bytes of a traversal call, for traversal_roofline_pct.

A call answers, for each of its live rays, the closest hit (or whether
any surface lies) along the ray's segment. Whatever implements it must at
least read every ray once, write every answer once, and read the scene's
content once:

- a ray in: origin and direction (6 float32) and tmin and tmax (2 float32),
  32 bytes;
- a hit out: t, the triangle's id and the two barycentrics u and v
  (4 x 4 bytes), 16 bytes (a shadow ray's answer is smaller; it is counted
  as a hit, which only raises the bound);
- the scene once a call: three float32 vertices a triangle (36 bytes) for
  the triangles of every geometry counted once (an instanced mesh once),
  and a 3 x 4 float32 transform (48 bytes) an instance.

The bound is these bytes over the card's memory bandwidth (peaks.json). The
count comes from the scene and the rays alone, not from the program's
layouts, tiles, sorts or skip counters, so it reads the same work whatever
implements the traversal, and the share of it can never pass 100 % unless
the time leaves out part of the work.
"""

RAY_BYTES = 32
HIT_BYTES = 16
TRI_BYTES = 36
INSTANCE_BYTES = 48


def scene_bytes(tris: int, instances: int) -> int:
    return tris * TRI_BYTES + instances * INSTANCE_BYTES


def call_bytes(live_rays: int, tris: int, instances: int) -> int:
    """Compulsory bytes of one call over `live_rays` rays."""
    return live_rays * (RAY_BYTES + HIT_BYTES) + scene_bytes(tris, instances)


def bytes_per_sample(live_rays: float, calls: float, tris: int, instances: int) -> float:
    """Compulsory bytes of one sample's traversal calls: `live_rays` and
    `calls` are the sample's live rays and calls."""
    return live_rays * (RAY_BYTES + HIT_BYTES) + calls * scene_bytes(tris, instances)
