"""K3 — shared stereo EWA preprocessing (paper Fig. 13 left) on Hopper.

`preprocess` launches `csrc/preprocess.cu` (a block per run of 256 rows,
staged through shared memory, one thread per Gaussian) for CUDA tensors and
runs `preprocess_plain` for CPU tensors. Both read the same camera values:
the plain version from the packed 26-float vector (`pack_camera`, the
layout of the reference's Pallas kernel), the kernel from the camera's
tensors where they lie and its host scalars (`camera_scalars`) by value,
so that on the card the wrapper makes no host→device copy and never waits
on the stream (it launches the kernel and the two small element-wise ops of
`StereoRig.right`). Both evaluate the same
float operations in the same order, with every 3x3 product written out as
((a0·b0 + a1·b1) + a2·b2); the kernel is built without FMA contraction, so
on the card the two agree to the last bit except where `expf`/`logf`
differ from PyTorch's.
"""

from __future__ import annotations

import torch

from repro_torch.core.gaussians import SH_C0, SH_C1, Gaussians
from repro_torch.core.projection import ALPHA_MIN, COV_BLUR, Splats
from repro_torch.kernels import _build
from repro_torch.numerics import div_rn, sqrt_rn

# packed camera params layout
_P_POS = 0          # 3
_P_ROT = 3          # 9 (row-major world→cam)
_P_FOCAL = 12
_P_CX = 13
_P_CY = 14
_P_NEAR = 15
_P_FAR = 16
_P_BASE = 17
_P_LPOS = 18        # 3 left eye pos
_P_RPOS = 21        # 3 right eye pos
_P_W = 24           # widened width
_P_H = 25
P_LEN = 26
OUT_COLS = 16


def camera_scalars(rig, wide) -> tuple:
    """The camera's host scalars (cx, cy, near, far, baseline, width,
    height) as Python floats."""
    return tuple(float(x) for x in (wide.cx, wide.cy, wide.near, wide.far, rig.baseline,
                                    wide.width, wide.height))


def pack_camera(rig, wide) -> torch.Tensor:
    """(26,) float32 camera vector on the camera's device. On the card this
    copies the host scalars to the device and waits for it: the plain
    version's path only."""
    dev = wide.pos.device
    host = torch.tensor(camera_scalars(rig, wide), dtype=torch.float32, device=dev)
    return torch.cat([
        wide.pos.reshape(3), wide.rot.T.reshape(9), wide.focal.reshape(1), host[:5],
        rig.left.pos.reshape(3), rig.right.pos.reshape(3), host[5:],
    ]).to(torch.float32).contiguous()


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sh_color(sh, dx, dy, dz, k: int):
    """(M, K, 3) SH, unit direction components (M,) → (M, 3)."""
    x, y, z = dx[:, None], dy[:, None], dz[:, None]
    c = SH_C0 * sh[:, 0, :]
    if k >= 4:
        c = c - SH_C1 * y * sh[:, 1, :] + SH_C1 * z * sh[:, 2, :] - SH_C1 * x * sh[:, 3, :]
    if k >= 9:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        c = (c + 1.0925484305920792 * xy * sh[:, 4, :]
             - 1.0925484305920792 * yz * sh[:, 5, :]
             + 0.31539156525252005 * (2.0 * zz - xx - yy) * sh[:, 6, :]
             - 1.0925484305920792 * xz * sh[:, 7, :]
             + 0.5462742152960396 * (xx - yy) * sh[:, 8, :])
    return torch.clamp_min(c + 0.5, 0.0)


def _unit_dir(mu, eye):
    d = [mu[:, i] - eye[i] for i in range(3)]
    n = sqrt_rn(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) + 1e-12
    return d[0] / n, d[1] / n, d[2] / n


def preprocess_plain(g: Gaussians, rig, wide) -> Splats:
    """The plain PyTorch version of K3: the reference's `project`, written
    per component in the kernel's order of operations."""
    k = g.sh.shape[1]
    if k not in (1, 4, 9):
        raise ValueError(f"preprocess: SH with K={k} coefficients is not supported")
    prm = pack_camera(rig, wide)
    pos = prm[_P_POS:_P_POS + 3]
    w2c = prm[_P_ROT:_P_ROT + 9].reshape(3, 3)
    f, cx, cy = prm[_P_FOCAL], prm[_P_CX], prm[_P_CY]
    near, far, baseline = prm[_P_NEAR], prm[_P_FAR], prm[_P_BASE]
    width, height = prm[_P_W], prm[_P_H]

    mu = g.mu
    d = [mu[:, i] - pos[i] for i in range(3)]
    t = [_dot3(d, w2c[i]) for i in range(3)]
    z = t[2]
    inv_z = 1.0 / torch.clamp_min(z, 1e-6)
    mx = f * t[0] * inv_z + cx
    my = f * t[1] * inv_z + cy

    q = g.quat
    qn = sqrt_rn(q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2]
                    + q[:, 3] * q[:, 3]) + 1e-12
    w_, x_, y_, z_ = (q[:, i] / qn for i in range(4))
    rot = [[1 - 2 * (y_ * y_ + z_ * z_), 2 * (x_ * y_ - w_ * z_), 2 * (x_ * z_ + w_ * y_)],
           [2 * (x_ * y_ + w_ * z_), 1 - 2 * (x_ * x_ + z_ * z_), 2 * (y_ * z_ - w_ * x_)],
           [2 * (x_ * z_ - w_ * y_), 2 * (y_ * z_ + w_ * x_), 1 - 2 * (x_ * x_ + y_ * y_)]]
    s = torch.exp(g.log_scale)
    rs = [[rot[i][j] * s[:, j] for j in range(3)] for i in range(3)]
    cov3 = [[_dot3(rs[i], rs[j]) for j in range(3)] for i in range(3)]

    zero = torch.zeros_like(z)
    jac = [[f * inv_z, zero, -f * t[0] * inv_z * inv_z],
           [zero, f * inv_z, -f * t[1] * inv_z * inv_z]]
    jw = [[_dot3(jac[r], w2c[:, c]) for c in range(3)] for r in range(2)]
    tmp = [[_dot3(jw[r], [cov3[kk][c] for kk in range(3)]) for c in range(3)]
           for r in range(2)]
    cov2 = [[_dot3(tmp[r], jw[c2]) for c2 in range(2)] for r in range(2)]
    a = cov2[0][0] + COV_BLUR
    b = cov2[0][1]
    c = cov2[1][1] + COV_BLUR
    det = torch.clamp_min(a * c - b * b, 1e-12)

    opa = g.opacity
    tau2 = torch.clamp_min(2.0 * torch.log(div_rn(torch.clamp_min(opa, ALPHA_MIN), ALPHA_MIN)), 0.0)
    ext_x = sqrt_rn(tau2 * a)
    ext_y = sqrt_rn(tau2 * c)

    col_l = _sh_color(g.sh, *_unit_dir(mu, prm[_P_LPOS:_P_LPOS + 3]), k)
    col_r = _sh_color(g.sh, *_unit_dir(mu, prm[_P_RPOS:_P_RPOS + 3]), k)

    visible = ((z > near) & (z < far) & (opa > ALPHA_MIN)
               & (mx + ext_x >= 0.0) & (mx - ext_x <= width)
               & (my + ext_y >= 0.0) & (my - ext_y <= height))
    return Splats(mean2d=torch.stack([mx, my], -1), depth=z,
                  conic=torch.stack([c / det, -b / det, a / det], -1),
                  ext=torch.stack([ext_x, ext_y], -1), color_l=col_l, color_r=col_r,
                  opacity=opa, disparity=baseline * f * inv_z, visible=visible)


def splats_from_rows(out: torch.Tensor, visible: torch.Tensor) -> Splats:
    """Split the kernel's (M, 16) rows and its (M,) visible flags into
    Splats fields."""
    return Splats(
        mean2d=out[:, 0:2], depth=out[:, 2], conic=out[:, 3:6], ext=out[:, 6:8],
        color_l=out[:, 8:11], color_r=out[:, 11:14], opacity=out[:, 14],
        disparity=out[:, 15], visible=visible)


def preprocess(g: Gaussians, rig, wide) -> Splats:
    """Project the render queue for both eyes. CPU tensors run the plain
    version; CUDA tensors launch K3."""
    dev = g.mu.device
    if dev.type == "cpu":
        return preprocess_plain(g, rig, wide)
    if dev.type != "cuda":
        raise ValueError(f"preprocess: unsupported device {dev}")
    m, k = g.n, g.sh.shape[1]
    if k not in (1, 4, 9):
        raise ValueError(f"preprocess: SH with K={k} coefficients is not supported "
                         "(degree <= 2)")
    for name, t, shape in (("mu", g.mu, (m, 3)), ("log_scale", g.log_scale, (m, 3)),
                           ("quat", g.quat, (m, 4)), ("opacity", g.opacity, (m,)),
                           ("sh", g.sh, (m, k, 3))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"preprocess: {name} must be float32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"preprocess: {name} must be contiguous")
    cam = []
    for name, t, n in (("position", wide.pos, 3), ("rotation", wide.rot, 9),
                       ("focal", wide.focal, 1), ("left eye position", rig.left.pos, 3),
                       ("right eye position", rig.right.pos, 3)):
        if t.device != dev or t.numel() != n:
            raise ValueError(f"preprocess: camera {name} must hold {n} values on {dev}, "
                             f"got {t.numel()} on {t.device}")
        cam.append(t.to(torch.float32).contiguous())
    out = torch.empty((m, OUT_COLS), dtype=torch.float32, device=dev)
    visible = torch.empty((m,), dtype=torch.bool, device=dev)
    if m > 0:
        lib = _build.library()
        p = _build.ptr
        err = lib.nebula_preprocess(p(g.mu), p(g.log_scale), p(g.quat), p(g.opacity),
                                    p(g.sh), *map(p, cam), *camera_scalars(rig, wide),
                                    p(out), p(visible), m, k, _build.stream_handle(dev))
        _build.check(err, "nebula_preprocess")
        preprocess.launches += 1
    return splats_from_rows(out, visible)


preprocess.launches = 0
