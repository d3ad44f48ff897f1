"""Rays aimed at the triangles that define a candidate's world box (or a
K1 tile's) and at sliver triangles, and a small instanced candidate list
to aim them at: shared by the CPU tests of the candidate test's skips
(tests/test_torch_candidate_cull.py, tests/test_torch_flat_cull.py), the
card's tests (tests/test_torch_gpu.py) and chip_smoke.py. Imports no jax."""
import numpy as np
import torch

from akari_render_tpu_torch.accel.cluster import ClusterArrays, build_clusters
from akari_render_tpu_torch.native import build_bvh_order


def instanced_soup(seed=7, T=1500, C=128, n_inst=3):
    """A unified candidate list as accel/instanced.py builds it, from
    seeded numpy: the clusters of one triangle soup once flat (identity
    rows) and n_inst times through a rotation, a scale and a translation
    (world boxes by centre and extent, world->local rows with the id
    offset, shared triangle rows). A quarter of the triangles left of x =
    -1.6 have zero area (e2 = e1 / 2), as the poles of a sphere mesh do, so
    some rows hold slivers and most do not."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-2, 2, (T, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.25, (T, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.25, (T, 3)).astype(np.float32)
    flat = (v0[:, 0] < -1.6) & (np.arange(T) % 4 == 0)
    e2[flat] = e1[flat] * np.float32(0.5)
    cl = build_clusters(v0, e1, e2, build_bvh_order(v0, e1, e2), cluster_size=C)
    K = cl.num_clusters
    lb, ub = cl.cbmin.numpy(), cl.cbmax.numpy()
    ident = np.zeros((K, 16), np.float32)
    ident[:, 0] = ident[:, 5] = ident[:, 10] = 1.0
    bmins, bmaxs, xfs = [lb], [ub], [ident]
    for i in range(n_inst):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        m = np.eye(4)
        m[:3, :3] = q * rng.uniform(0.5, 2.0)
        m[:3, 3] = rng.uniform(-6, 6, 3)
        m = m.astype(np.float32)
        minv = np.linalg.inv(m.astype(np.float64)).astype(np.float32)
        c, e = (lb + ub) * 0.5, (ub - lb) * 0.5
        wc = c @ m[:3, :3].T + m[:3, 3]
        we = e @ np.abs(m[:3, :3]).T
        bmins.append((wc - we).astype(np.float32))
        bmaxs.append((wc + we).astype(np.float32))
        xf = np.zeros((K, 16), np.float32)
        xf[:, :12] = minv[:3].reshape(-1)
        xf[:, 12] = np.float32((i + 1) * 4096)
        xfs.append(xf)
    return ClusterArrays(
        cbmin=torch.as_tensor(np.concatenate(bmins)), cbmax=torch.as_tensor(np.concatenate(bmaxs)),
        tri=cl.tri, order=torch.zeros((0,), dtype=torch.int32),
        xf=torch.as_tensor(np.concatenate(xfs)),
        tri_row=torch.as_tensor(np.tile(np.arange(K, dtype=np.int32), n_inst + 1)))


def local_to_world(xf_row):
    """Invert a world->local row [16] (3x4 affine): (R [3, 3], t [3]) of the
    local->world map, in float64."""
    m = xf_row[:12].double().reshape(3, 4).numpy()
    r = np.linalg.inv(m[:, :3])
    return r, -r @ m[:, 3]


def face_targets(cl, ci, rng, per_face=6):
    """World-space points on the triangles that define candidate ci's box:
    for each of its six faces, the triangle vertex that reaches it, points
    along the two edges that meet there, and points just inside that
    triangle. Returns the points [n, 3] and, for each, the unit normal of
    its triangle's plane."""
    row = int(cl.tri_row[ci]) if cl.tri_row is not None else ci
    tri = cl.tri[row].double().numpy()
    tri = tri[tri[:, 9] >= 0]
    r, t = local_to_world(cl.xf[ci])
    verts = np.stack([tri[:, 0:3], tri[:, 0:3] + tri[:, 3:6], tri[:, 0:3] + tri[:, 6:9]], 1)
    world = verts @ r.T + t  # [T, 3 verts, 3]
    out, normals = [], []
    for axis in range(3):
        for pick in (np.argmin, np.argmax):
            ti, vi = np.unravel_index(pick(world[:, :, axis]), world.shape[:2])
            a, b, c = world[ti, vi], world[ti, (vi + 1) % 3], world[ti, (vi + 2) % 3]
            out.append(a)
            for _ in range(per_face):
                s_ = rng.random() * 0.2
                out += [a + s_ * (b - a), a + s_ * (c - a),
                        a + 0.01 * rng.random() * (b - a) + 0.01 * rng.random() * (c - a)]
            nrm = np.cross(b - a, c - a)
            if not nrm.any():  # a zero-area triangle: any plane through it
                nrm = np.eye(3)[axis]
            normals += [nrm / np.linalg.norm(nrm)] * (1 + 3 * per_face)
    return np.asarray(out), np.asarray(normals)


def aimed_rays(cl, cands, how, seed):
    """Rays aimed at face_targets of `cands`: head-on (along the normal of
    the face the target lies on, from outside the box), grazing (within a
    few 1e-4 rad of that face's plane), plane_grazing (within 1e-6 to 1e-4
    rad, log-uniform and either side, of the plane of the target's own
    triangle, where the Möller-Trumbore solve is worst conditioned) or from
    random directions, from 0.01 to 10 units away. Returns o, d [n, 3] float32 and the distance to
    the target."""
    rng = np.random.default_rng(seed)
    os_, ds_, dist = [], [], []
    for ci in cands:
        tg, tri_normal = face_targets(cl, ci, rng)
        n = len(tg)
        axis = np.repeat(np.arange(3), n // 3)[:n]
        sign = np.where((np.arange(n) // (n // 6)) % 2 == 0, -1.0, 1.0)
        normal = np.zeros((n, 3))
        normal[np.arange(n), axis] = sign
        rnd = rng.normal(size=(n, 3))
        rnd /= np.linalg.norm(rnd, axis=-1, keepdims=True)
        if how == "head_on":
            back = normal
        elif how == "grazing":
            tang = rnd - (rnd * normal).sum(-1, keepdims=True) * normal
            tang /= np.linalg.norm(tang, axis=-1, keepdims=True)
            back = tang + normal * rng.uniform(-3e-4, 3e-4, (n, 1))
            back /= np.linalg.norm(back, axis=-1, keepdims=True)
        elif how == "plane_grazing":
            tang = rnd - (rnd * tri_normal).sum(-1, keepdims=True) * tri_normal
            tang /= np.linalg.norm(tang, axis=-1, keepdims=True)
            angle = 10.0 ** rng.uniform(-6, -4, (n, 1)) * rng.choice([-1.0, 1.0], (n, 1))
            back = tang + tri_normal * angle
            back /= np.linalg.norm(back, axis=-1, keepdims=True)
        else:
            back = rnd
        far = 10.0 ** rng.uniform(-2, 1, (n, 1))
        os_.append(tg + back * far)
        ds_.append(-back)
        dist.append(far[:, 0])
    o = np.concatenate(os_).astype(np.float32)
    d = np.concatenate(ds_).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.concatenate(dist).astype(np.float32)


def tile_clusters(tiles):
    """K1's tiles (accel/intersect.py FlatTiles) as flat candidates of a
    ClusterArrays (identity rows, the tiles' boxes), on the CPU: what
    face_targets and aimed_rays take."""
    nt = tiles.slots.shape[0]
    ident = torch.zeros((nt, 16))
    ident[:, 0] = ident[:, 5] = ident[:, 10] = 1.0
    b = tiles.boxes.cpu()
    return ClusterArrays(cbmin=b[0:3].T.contiguous(), cbmax=b[3:6].T.contiguous(),
                         tri=tiles.tri.cpu(), order=torch.zeros((0,), dtype=torch.int32),
                         xf=ident)


def sliver_rays(v0, e1, e2, ids, per, seed):
    """Rays through points of the triangles `ids` of a soup (numpy [T, 3]
    arrays), from random directions, 0.01 to 10 units away: on a sliver
    (zero-area) triangle Möller-Trumbore's determinant is rounding noise,
    and a ray through the sliver's line meets it in rounding. Returns o, d
    [len(ids) * per, 3] float32."""
    rng = np.random.default_rng(seed)
    a = np.repeat(v0[ids].astype(np.float64), per, axis=0)
    s = rng.random((len(a), 2)) * [1.0, 0.01]
    p = a + s[:, :1] * np.repeat(e1[ids], per, axis=0) + s[:, 1:] * np.repeat(e2[ids], per, axis=0)
    d = rng.normal(size=p.shape)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = p - d * 10.0 ** rng.uniform(-2, 1, (len(p), 1))
    return o.astype(np.float32), d.astype(np.float32)
