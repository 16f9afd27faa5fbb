"""Per-Gaussian forward preprocess: frustum cull, projection, EWA 2D covariance, conic,
screen radius, tile rect, SH->RGB.

PyTorch counterpart of `langsplat_tpu/ops/projection.py:102 preprocess`, with the same
numeric conventions:
  - matrices are row-vector convention (`p_hom = [p,1] @ M`);
  - near-cull at view z <= 0.2; projective divide by (w + 1e-7);
  - EWA Jacobian clamps x/z and y/z to +-1.3*tanfov; +0.3 low-pass dilation on the 2D
    covariance diagonal;
  - radius = ceil(3 * sqrt(max eigenvalue)); ndc->pix v -> ((v+1)*S - 1)/2.

The K=4 and K=3 contractions are written out elementwise, as in the JAX package, so
they are exact float32 whatever the matmul precision setting (TF32 would move
projected positions by pixels).

Dispatch is by device only, as in `rasterize_cuda`: CPU tensors take the plain version
(`preprocess_plain`, the elementwise code above); CUDA tensors take the kernels of
`csrc/preprocess.cu`, one launch forward and one backward, joined by `_Preprocess`;
anything the kernels do not take raises. The kernels repeat the plain version's float32
arithmetic in its order, so radii, tile rects and `visible` are bit-equal to it on the
card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from langsplat_tpu_torch.core import sh as sh_lib
from langsplat_tpu_torch.core import transforms
from langsplat_tpu_torch.ops import _build

#: most SH coefficients a row (degree 4) the kernels take
MAX_COEFFS = 25


class PreprocessOut(NamedTuple):
    """Per-Gaussian screen-space quantities (all [N, ...]; padded slots are invalid)."""
    means2d: torch.Tensor    # [N, 2] pixel coords
    depths: torch.Tensor     # [N] view-space z
    conics: torch.Tensor     # [N, 3] inverse 2D covariance (a, b, c): ax^2 + 2bxy + cy^2
    radii: torch.Tensor      # [N] int32 screen radius in pixels (0 => invisible)
    colors: torch.Tensor     # [N, 3] RGB from SH (or passthrough of colors_precomp)
    tiles_min: torch.Tensor  # [N, 2] int32 inclusive (tx0, ty0)
    tiles_max: torch.Tensor  # [N, 2] int32 exclusive (tx1, ty1)
    visible: torch.Tensor    # [N] bool: survives cull and has nonzero radius


def _affine4(points: torch.Tensor, matrix: torch.Tensor, cols: int) -> torch.Tensor:
    """Row-vector transform [x y z 1] @ matrix[:, :cols] as exact-f32 elementwise ops."""
    x, y, z = points[:, 0:1], points[:, 1:2], points[:, 2:3]
    m = matrix
    return x * m[0, :cols] + y * m[1, :cols] + z * m[2, :cols] + m[3, :cols]


def project_points(means3d: torch.Tensor, viewmatrix: torch.Tensor,
                   projmatrix: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (p_view [N,3], p_ndc [N,3]). Row-vector convention."""
    p_view = _affine4(means3d, viewmatrix, 3)
    p_hom = _affine4(means3d, projmatrix, 4)
    p_ndc = p_hom[:, :3] / (p_hom[:, 3:4] + 1e-7)
    return p_view, p_ndc


def compute_cov2d(means3d: torch.Tensor, cov3d: torch.Tensor, viewmatrix: torch.Tensor,
                  tanfovx: float, tanfovy: float, focal_x: float,
                  focal_y: float) -> torch.Tensor:
    """EWA splat of the 3D covariance to screen space; returns [N, 3] (xx, xy, yy):
    cov2d = J W Sigma W^T J^T + diag(0.3, 0.3)."""
    t = _affine4(means3d, viewmatrix, 3)
    tz = t[:, 2]
    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    txtz = torch.clamp(t[:, 0] / tz, -limx, limx)
    tytz = torch.clamp(t[:, 1] / tz, -limy, limy)
    tx = txtz * tz
    ty = tytz * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(tz)
    J = [[focal_x * inv_z, zeros, -focal_x * tx * inv_z2],
         [zeros, focal_y * inv_z, -focal_y * ty * inv_z2]]

    W = viewmatrix[:3, :3].T  # world->view rotation acting on column vectors
    T = [[sum(J[i][j] * W[j, k] for j in range(3)) for k in range(3)]
         for i in range(2)]  # [2][3] of [N]
    TS = [[sum(T[i][j] * cov3d[:, j, k] for j in range(3)) for k in range(3)]
          for i in range(2)]  # T @ Sigma
    xx = sum(TS[0][k] * T[0][k] for k in range(3)) + 0.3
    xy = sum(TS[0][k] * T[1][k] for k in range(3))
    yy = sum(TS[1][k] * T[1][k] for k in range(3)) + 0.3
    return torch.stack([xx, xy, yy], dim=-1)


def _trunc_clip(x: torch.Tensor, hi: int) -> torch.Tensor:
    """int32 truncation toward zero clipped to [0, hi], defined for every float:
    NaN gives 0 and out-of-range values saturate, as XLA's conversion does (a plain
    float->int cast of NaN or of values past int32 is undefined)."""
    x = torch.clamp(torch.nan_to_num(x, nan=0.0), -1.0, hi + 1.0)
    return torch.clamp(x.to(torch.int32), 0, hi)


def preprocess_plain(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    shs: torch.Tensor | None,
    viewmatrix: torch.Tensor,
    projmatrix: torch.Tensor,
    campos: torch.Tensor,
    *,
    image_height: int,
    image_width: int,
    tanfovx: float,
    tanfovy: float,
    sh_degree: int,
    tile_size: int,
    scale_modifier: float = 1.0,
    cov3d_precomp: torch.Tensor | None = None,
    colors_precomp: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
) -> PreprocessOut:
    """Plain PyTorch version of `preprocess` (same arguments and result), vectorized
    over the (padded) Gaussian axis; autograd gives its backward."""
    focal_x = image_width / (2.0 * tanfovx)
    focal_y = image_height / (2.0 * tanfovy)

    p_view, p_ndc = project_points(means3d, viewmatrix, projmatrix)
    depths = p_view[:, 2]
    in_front = depths > 0.2

    if cov3d_precomp is not None:
        cov3d = transforms.unstrip_symmetric(cov3d_precomp)
    else:
        cov3d = transforms.build_covariance_3d(scales, quats, scale_modifier)
    cov2d = compute_cov2d(means3d, cov3d, viewmatrix, tanfovx, tanfovy, focal_x, focal_y)

    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] ** 2
    det_ok = det != 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    conics = torch.stack([cov2d[:, 2] * inv_det, -cov2d[:, 1] * inv_det,
                          cov2d[:, 0] * inv_det], dim=-1)

    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lambda1 = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, mid - disc)))

    means2d = torch.stack([
        ((p_ndc[:, 0] + 1.0) * image_width - 1.0) * 0.5,
        ((p_ndc[:, 1] + 1.0) * image_height - 1.0) * 0.5,
    ], dim=-1)

    grid_x = (image_width + tile_size - 1) // tile_size
    grid_y = (image_height + tile_size - 1) // tile_size
    tmin_x = _trunc_clip((means2d[:, 0] - radius_f) / tile_size, grid_x)
    tmin_y = _trunc_clip((means2d[:, 1] - radius_f) / tile_size, grid_y)
    tmax_x = _trunc_clip(torch.floor_divide(means2d[:, 0] + radius_f + tile_size - 1,
                                            tile_size), grid_x)
    tmax_y = _trunc_clip(torch.floor_divide(means2d[:, 1] + radius_f + tile_size - 1,
                                            tile_size), grid_y)
    touches = (tmax_x - tmin_x) * (tmax_y - tmin_y) > 0

    visible = in_front & det_ok & touches
    if alive is not None:
        visible = visible & alive
    radii = _trunc_clip(torch.where(visible, radius_f, 0.0), 2**30)

    if colors_precomp is not None:
        colors = colors_precomp
    else:
        if shs is None:
            raise ValueError("either shs or colors_precomp must be given")
        dirs = means3d - campos[None, :]
        dirs = dirs / (torch.linalg.vector_norm(dirs, dim=-1, keepdim=True) + 1e-12)
        colors = sh_lib.sh_to_color(sh_degree, shs.transpose(-1, -2), dirs)

    return PreprocessOut(
        means2d=means2d,
        depths=depths,
        conics=conics,
        radii=radii,
        colors=colors,
        tiles_min=torch.stack([tmin_x, tmin_y], dim=-1),
        tiles_max=torch.stack([tmax_x, tmax_y], dim=-1),
        visible=visible,
    )


# ---------------------------------------------------------------------------
# The kernels of csrc/preprocess.cu
# ---------------------------------------------------------------------------

def check_kernel_inputs(means3d, scales, quats, shs, viewmatrix, projmatrix, campos, *,
                        sh_degree, tile_size, cov3d_precomp=None, alive=None) -> None:
    """Raise on inputs the kernels do not take: float32 contiguous tensors of the plain
    version's shapes on one device (`shs` [N, K, 3] with (sh_degree + 1)**2 <= K <=
    MAX_COEFFS, or None when colours are given; `scales` and `quats` only without
    `cov3d_precomp`), a bool `alive`, and float32 camera tensors (of any strides) that
    do not require grad."""
    device = means3d.device
    n = means3d.shape[0]
    f32 = torch.float32
    _build.check("means3d", means3d, f32, (n, 3), device)
    if cov3d_precomp is not None:
        _build.check("cov3d_precomp", cov3d_precomp, f32, (n, 6), device)
    else:
        _build.check("scales", scales, f32, (n, 3), device)
        _build.check("quats", quats, f32, (n, 4), device)
    if shs is not None:
        if not 0 <= sh_degree <= 4:
            raise ValueError(f"SH degree must be in [0,4], got {sh_degree}")
        if shs.dim() != 3:
            raise ValueError(f"shs must be [N, K, 3], got {tuple(shs.shape)}")
        k = shs.shape[1]
        if not (sh_degree + 1) ** 2 <= k <= MAX_COEFFS:
            raise ValueError(f"shs holds {k} coefficients a row; the kernels take "
                             f"{(sh_degree + 1) ** 2} (degree {sh_degree}) to {MAX_COEFFS}")
        _build.check("shs", shs, f32, (n, k, 3), device)
    for name, t, shape in (("viewmatrix", viewmatrix, (4, 4)),
                           ("projmatrix", projmatrix, (4, 4)), ("campos", campos, (3,))):
        _build.check(name, t, f32, shape, device, contiguous=False)   # read through strides
        if t.requires_grad:
            raise ValueError(f"{name} requires grad; the kernels give no gradient of the "
                             f"camera")
    if alive is not None:
        _build.check("alive", alive, torch.bool, (n,), device)
    if tile_size < 1:
        raise ValueError(f"tile_size must be positive, got {tile_size}")


def _scalars(n, shs, viewmatrix, projmatrix, campos, options) -> list:
    """The kernels' size and camera arguments, rounded to float32 as the plain version's
    Python scalars are, and the camera tensors' strides."""
    o = options
    ts = o["tile_size"]
    focal_x = o["image_width"] / (2.0 * o["tanfovx"])
    focal_y = o["image_height"] / (2.0 * o["tanfovy"])
    return [n, 0 if shs is None else shs.shape[1], o["sh_degree"], o["image_width"],
            o["image_height"], ts, (o["image_width"] + ts - 1) // ts,
            (o["image_height"] + ts - 1) // ts, *(ctypes.c_float(v) for v in (
                focal_x, focal_y, 1.3 * o["tanfovx"], 1.3 * o["tanfovy"],
                o["scale_modifier"])), *viewmatrix.stride(), *projmatrix.stride(),
            campos.stride(0)]


_PTR, _LL = ctypes.c_void_p, ctypes.c_longlong
_SCALAR_TYPES = [ctypes.c_int] * 8 + [ctypes.c_float] * 5 + [ctypes.c_int] * 5
_FORWARD = _build.Kernel("preprocess.cu", "preprocess_fwd",
                         [_PTR] * 9 + _SCALAR_TYPES + [_PTR] * 8)
_BACKWARD = _build.Kernel("preprocess.cu", "preprocess_bwd",
                          [_PTR] * 8 + _SCALAR_TYPES
                          + [_PTR, _LL, _LL, _PTR, _LL, _PTR, _LL, _LL, _PTR, _LL, _LL]
                          + [_PTR] * 5)


def preprocess_forward_cuda(means3d, scales, quats, shs, cov3d_precomp, viewmatrix,
                            projmatrix, campos, alive, options) -> tuple:
    """Launch the forward kernel on the tensors' CUDA device and current stream:
    (means2d, depths, conics, radii, tiles_min, tiles_max, visible, colors), colors None
    without `shs`. `options` holds preprocess's keyword sizes; inputs that
    `check_kernel_inputs` refuses raise."""
    if means3d.device.type != "cuda":
        raise ValueError(f"preprocess_forward_cuda needs CUDA tensors, got "
                         f"{means3d.device}")
    check_kernel_inputs(means3d, scales, quats, shs, viewmatrix, projmatrix, campos,
                        sh_degree=options["sh_degree"], tile_size=options["tile_size"],
                        cov3d_precomp=cov3d_precomp, alive=alive)
    device = means3d.device
    n = means3d.shape[0]
    f32, i32 = torch.float32, torch.int32
    means2d = torch.empty((n, 2), dtype=f32, device=device)
    depths = torch.empty((n,), dtype=f32, device=device)
    conics = torch.empty((n, 3), dtype=f32, device=device)
    radii = torch.empty((n,), dtype=i32, device=device)
    tiles_min = torch.empty((n, 2), dtype=i32, device=device)
    tiles_max = torch.empty((n, 2), dtype=i32, device=device)
    visible = torch.empty((n,), dtype=torch.bool, device=device)
    colors = None if shs is None else torch.empty((n, 3), dtype=f32, device=device)
    _FORWARD(device, means3d, scales, quats, shs, cov3d_precomp, alive, viewmatrix,
             projmatrix, campos, *_scalars(n, shs, viewmatrix, projmatrix, campos, options),
             means2d, depths, conics, radii, colors, tiles_min, tiles_max, visible)
    return means2d, depths, conics, radii, tiles_min, tiles_max, visible, colors


def _grad_in(g, n, width):
    """(tensor, row stride, column stride) of an incoming gradient, read in place."""
    if g is None:
        return [None, 0, 0] if width else [None, 0]
    if g.dtype != torch.float32 or tuple(g.shape) != ((n, width) if width else (n,)):
        raise ValueError(f"a preprocess output gradient has dtype {g.dtype} and shape "
                         f"{tuple(g.shape)}")
    return [g, *g.stride()] if width else [g, g.stride(0)]


def preprocess_backward_cuda(means3d, scales, quats, shs, cov3d_precomp, viewmatrix,
                             projmatrix, campos, options, g_means2d, g_depths, g_conics,
                             g_colors, needs) -> tuple:
    """Launch the backward kernel: (dL/dmeans3d, dL/dscales, dL/dquats, dL/dshs,
    dL/dcov3d_precomp) from the output gradients (each may be None, and is read through
    its strides), an entry None where `needs` (flags in that order) is False or the
    input was not given."""
    device = means3d.device
    n = means3d.shape[0]
    f32 = torch.float32

    def out(flag, like):
        return (torch.empty(like.shape, dtype=f32, device=device)
                if flag and like is not None else None)

    grads = [out(flag, like) for flag, like in zip(
        needs, (means3d, None if cov3d_precomp is not None else scales,
                None if cov3d_precomp is not None else quats, shs, cov3d_precomp))]
    _BACKWARD(device, means3d, scales, quats, shs, cov3d_precomp, viewmatrix, projmatrix,
              campos, *_scalars(n, shs, viewmatrix, projmatrix, campos, options),
              *_grad_in(g_means2d, n, 2), *_grad_in(g_depths, n, 0),
              *_grad_in(g_conics, n, 3), *_grad_in(g_colors, n, 3), *grads)
    return tuple(grads)


class _Preprocess(torch.autograd.Function):
    """Projection and SH: the forward kernel, and the backward kernel for the inputs
    that require grad (nothing is saved when none does)."""

    @staticmethod
    def forward(ctx, means3d, scales, quats, shs, cov3d_precomp, viewmatrix, projmatrix,
                campos, alive, options):
        outs = preprocess_forward_cuda(means3d, scales, quats, shs, cov3d_precomp,
                                       viewmatrix, projmatrix, campos, alive, options)
        ctx.mark_non_differentiable(*outs[3:7])     # radii, tile rect, visible
        ctx.set_materialize_grads(False)           # absent output gradients stay None
        ctx.options = options
        if any(ctx.needs_input_grad[:5]):
            ctx.save_for_backward(means3d, scales, quats, shs, cov3d_precomp, viewmatrix,
                                  projmatrix, campos)
        return outs if shs is not None else outs[:7]

    @staticmethod
    def backward(ctx, g_means2d, g_depths, g_conics, *rest):
        g_colors = rest[4] if len(rest) > 4 else None
        needs = ctx.needs_input_grad[:5]
        if g_means2d is None and g_depths is None and g_conics is None and g_colors is None:
            return (None,) * 10
        grads = preprocess_backward_cuda(*ctx.saved_tensors, ctx.options, g_means2d,
                                         g_depths, g_conics, g_colors, needs)
        return grads + (None,) * 5


def preprocess_cuda(means3d, scales, quats, shs, viewmatrix, projmatrix, campos, *,
                    image_height, image_width, tanfovx, tanfovy, sh_degree, tile_size,
                    scale_modifier=1.0, cov3d_precomp=None, colors_precomp=None,
                    alive=None) -> PreprocessOut:
    """`preprocess` on the kernels (CUDA tensors; arguments and result as there):
    one launch forward and, when an input requires grad, one in the backward. Inputs of
    other strides are made contiguous first; other dtypes, shapes or a camera that
    requires grad raise."""
    if colors_precomp is None and shs is None:
        raise ValueError("either shs or colors_precomp must be given")
    if colors_precomp is not None:
        shs = None
    if cov3d_precomp is not None:
        scales = quats = None
    # the kernels take contiguous rows; a field's leaves may be column views of a flat
    # buffer (the data-parallel steps' `unflat_rows`): copied here, as the plain version
    # reads them, with autograd through the copy
    means3d, scales, quats, shs, cov3d_precomp, alive = (
        None if t is None else t.contiguous()
        for t in (means3d, scales, quats, shs, cov3d_precomp, alive))
    options = dict(image_height=image_height, image_width=image_width, tanfovx=tanfovx,
                   tanfovy=tanfovy, sh_degree=sh_degree, tile_size=tile_size,
                   scale_modifier=scale_modifier)
    out = _Preprocess.apply(means3d, scales, quats, shs, cov3d_precomp, viewmatrix,
                            projmatrix, campos, alive, options)
    means2d, depths, conics, radii, tiles_min, tiles_max, visible = out[:7]
    return PreprocessOut(
        means2d=means2d, depths=depths, conics=conics, radii=radii,
        colors=colors_precomp if colors_precomp is not None else out[7],
        tiles_min=tiles_min, tiles_max=tiles_max, visible=visible)


def preprocess(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    shs: torch.Tensor | None,
    viewmatrix: torch.Tensor,
    projmatrix: torch.Tensor,
    campos: torch.Tensor,
    *,
    image_height: int,
    image_width: int,
    tanfovx: float,
    tanfovy: float,
    sh_degree: int,
    tile_size: int,
    scale_modifier: float = 1.0,
    cov3d_precomp: torch.Tensor | None = None,
    colors_precomp: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
) -> PreprocessOut:
    """Per-Gaussian screen-space quantities, over the (padded) Gaussian axis.

    `alive` masks padded capacity slots: dead slots come out invisible with radius 0,
    so they never enter binning or blending. CPU tensors take the plain version; CUDA
    tensors take the kernels.
    """
    fn = preprocess_cuda if means3d.device.type == "cuda" else preprocess_plain
    return fn(means3d, scales, quats, shs, viewmatrix, projmatrix, campos,
              image_height=image_height, image_width=image_width, tanfovx=tanfovx,
              tanfovy=tanfovy, sh_degree=sh_degree, tile_size=tile_size,
              scale_modifier=scale_modifier, cov3d_precomp=cov3d_precomp,
              colors_precomp=colors_precomp, alive=alive)
