"""Sparse image warp: an order-2 polyharmonic spline, then a dense bilinear warp
(counterpart of speech_recognition_tpu/ops/warp.py, batched over clips).

tfa.image.sparse_image_warp with ``num_boundary_points=3``, as SpecAugment's
time warp calls it:

1. control-point flows = dest - source locations;
2. 8 zero-flow points pinned on the image boundary (a 3x3 grid minus the centre);
3. a dense flow interpolated by the order-2 polyharmonic (thin plate) spline
   ``phi(r^2) = 0.5 r^2 log(max(r^2, 1e-10))`` plus an affine term
   (``polyharmonic_interpolate`` in JAX): one (n + 3) x (n + 3) system per
   image, all of a batch in one ``torch.linalg.solve_ex`` (no error check, so
   the card never waits on the host), then the spline at every pixel
   (``dense_flow``);
4. ``output[y, x] = bilinear(image, (y, x) - flow[y, x])`` with the samples
   clamped to the image and the lower corner to [0, size - 2].

Everything is float32, as in JAX: the callers keep TF32 off
(``run/common.py select_device``).
"""

import numpy as np
import torch

_EPSILON = 1e-10


def _phi_order2(r_sq: torch.Tensor) -> torch.Tensor:
    """0.5 * r^2 * log(r^2), the order-2 polyharmonic kernel (JAX's rounding: (0.5 r^2) times the log)."""
    return torch.clamp(r_sq, min=_EPSILON).log_().mul_(0.5 * r_sq)


def _pairwise_sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, n, 2] x [B, m, 2] -> [B, n, m] squared distances."""
    diff = a[:, :, None, :] - b[:, None, :, :]
    return (diff * diff).sum(-1)


def _grid_sq_dist(H: int, W: int, points: torch.Tensor) -> torch.Tensor:
    """Squared distances from every pixel of an H x W grid (row-major) to [B, n, 2] points: [B, H*W, n].

    The values ``_pairwise_sq_dist`` gives for the grid's coordinates (one rounded square per axis, then
    their sum), from [B, H, n] and [B, W, n] terms."""
    dy = torch.arange(H, dtype=points.dtype, device=points.device)[None, :, None] - points[:, None, :, 0]
    dx = torch.arange(W, dtype=points.dtype, device=points.device)[None, :, None] - points[:, None, :, 1]
    return ((dy * dy)[:, :, None, :] + (dx * dx)[:, None, :, :]).reshape(points.shape[0], H * W, points.shape[1])


def spline_coefficients(train_points: torch.Tensor, train_values: torch.Tensor) -> torch.Tensor:
    """The spline's [B, n + 3, v] coefficients (n kernel weights, then the affine term's 3 rows) from
    [B, n, 2] control points and their [B, n, v] values: all B systems in one ``solve_ex``."""
    Bsz, n, _ = train_points.shape
    ones = torch.ones(Bsz, n, 1, dtype=train_points.dtype, device=train_points.device)
    matrix_a = _phi_order2(_pairwise_sq_dist(train_points, train_points))  # [B, n, n]
    matrix_b = torch.cat([train_points, ones], dim=2)  # [B, n, 3]
    top = torch.cat([matrix_a, matrix_b], dim=2)
    bottom = torch.cat([matrix_b.transpose(1, 2), matrix_b.new_zeros(Bsz, 3, 3)], dim=2)
    lhs = torch.cat([top, bottom], dim=1)  # [B, n + 3, n + 3]
    rhs = torch.cat([train_values, train_values.new_zeros(Bsz, 3, train_values.shape[2])], dim=1)
    return torch.linalg.solve_ex(lhs, rhs, check_errors=False)[0]


def boundary_locations(height: int, width: int) -> np.ndarray:
    """The 8 zero-flow points: a 3x3 grid over the image minus its centre, [8, 2] (y, x) float32."""
    ys = np.linspace(0.0, height - 1.0, 3)
    xs = np.linspace(0.0, width - 1.0, 3)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    pts = np.stack([yy.ravel(), xx.ravel()], axis=-1)
    return pts[np.arange(9) != 4].astype(np.float32)


def bilinear_sample(image: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Sample ``image`` [B, H, W, C] at ``query`` [B, H*W, 2] (y, x), clamped to the edges: [B, H*W, C]."""
    Bsz, H, W, C = image.shape
    y = torch.clamp(query[..., 0], 0.0, H - 1.0)
    x = torch.clamp(query[..., 1], 0.0, W - 1.0)
    y0 = torch.clamp(torch.floor(y).long(), 0, H - 2) if H > 1 else torch.zeros_like(y, dtype=torch.long)
    x0 = torch.clamp(torch.floor(x).long(), 0, W - 2) if W > 1 else torch.zeros_like(x, dtype=torch.long)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    wy = (y - y0.to(y.dtype))[..., None]
    wx = (x - x0.to(x.dtype))[..., None]
    flat = image.reshape(Bsz, H * W, C)

    def at(yi, xi):
        return torch.gather(flat, 1, (yi * W + xi)[..., None].expand(-1, -1, C))

    top = at(y0, x0) * (1.0 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1.0 - wx) + at(y1, x1) * wx
    return top * (1.0 - wy) + bot * wy


def pixel_grid(H: int, W: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Every pixel's (y, x), row-major: [H*W, 2]."""
    yy, xx = torch.meshgrid(torch.arange(H, dtype=dtype, device=device), torch.arange(W, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)


def dense_flow(H: int, W: int, source_points: torch.Tensor, dest_points: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """The spline's flow at every pixel of an H x W image: [B, H*W, 2], from [B, k, 2] control points.

    JAX's ``polyharmonic_interpolate`` over the grid, with the 8 boundary points' kernel columns, the same for
    every image of the batch, computed once: [H*W, 8] against all images' weights in one product, beside
    the [B, H*W, k] columns of the images' own points and the affine term."""
    Bsz, k, device = source_points.shape[0], source_points.shape[1], source_points.device
    boundary = torch.from_numpy(boundary_locations(H, W)).to(device, dtype)
    dest = dest_points.to(dtype)
    train_points = torch.cat([dest, boundary.expand(Bsz, 8, 2)], dim=1)
    flows = torch.cat([dest - source_points.to(dtype), dest.new_zeros(Bsz, 8, 2)], dim=1)
    coeffs = spline_coefficients(train_points, flows)  # [B, k + 8 + 3, 2]
    w_own, w_shared, v = coeffs[:, :k], coeffs[:, k:k + 8], coeffs[:, k + 8:]
    phi_shared = _phi_order2(_grid_sq_dist(H, W, boundary[None]))[0]  # [H*W, 8]
    flow = (phi_shared @ w_shared.permute(1, 0, 2).reshape(8, Bsz * 2)).view(H * W, Bsz, 2).transpose(0, 1)
    flow = flow + _phi_order2(_grid_sq_dist(H, W, dest)) @ w_own
    grid = pixel_grid(H, W, dtype, device)
    return flow + (grid[:, :1] * v[:, None, 0] + grid[:, 1:] * v[:, None, 1] + v[:, None, 2])


def sparse_image_warp(image: torch.Tensor, source_points: torch.Tensor, dest_points: torch.Tensor) -> torch.Tensor:
    """Warp each image of ``image`` [B, H, W, C] so its pixels at ``source_points`` move to
    ``dest_points`` ([B, k, 2] (y, x) float), the boundary pinned by 8 zero-flow points."""
    H, W = image.shape[1:3]
    flow = dense_flow(H, W, source_points, dest_points)  # [B, H*W, 2]
    warped = bilinear_sample(image.float(), pixel_grid(H, W, device=image.device) - flow)
    return warped.reshape(image.shape).to(image.dtype)
