"""Rigid SDF-2-SDF registration. Twin of ``levelsetfusion_tpu/models/rigid.py``.

Gauss–Newton on twist coordinates, minimising the voxel-wise TSDF
difference  E(ξ) = ½ Σ_v m_v (Φ_live(v; ξ) − Φ_canonical(v))², where the
live TSDF is regenerated from the depth image under the current pose every
iteration and m_v masks to the union narrow band.

An iteration:
  1. the live field Φ(v) = tsdf(depth, extrinsic=T) on the canonical grid;
  2. the per-voxel Jacobian J_v = (∇_q Φ)ᵀ ∂q/∂ξ with ∇_q Φ = R ∇_p Φ
     (central differences, in meters) and
       2D (ξ = δtx, δtz, δθ):  ∂q/∂ξ = [I₂ | dR/dθ · p]
       3D (ξ = δt, δω):        ∂q/∂ξ = [I₃ | −[q]×]
     (a small-twist increment multiplied on the left; q the current
     camera-frame point);
  3. the normal equations (Σ m J Jᵀ + λI) δ = −Σ m J e, summed over the full
     grid in f32 (the package turns TF32 off), solved by ``solve_ex``, and
     T ← exp(δ̂) ∘ T.

Every iteration is enqueued on the depth's device with no read back to the
host (``torch.linalg.solve`` would check the factorisation there): the
fixed iteration count runs as JAX's ``fori_loop`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from levelsetfusion_tpu_torch.core.camera import Camera2d, PinholeCamera, identity_extrinsic
from levelsetfusion_tpu_torch.core.grid import GridSpec, voxel_center_coordinates
from levelsetfusion_tpu_torch.ops import derivatives
from levelsetfusion_tpu_torch.ops.tsdf import GenerationMethod, generate_tsdf_2d, generate_tsdf_3d


class Sdf2SdfResult(NamedTuple):
    extrinsic: torch.Tensor  # final camera-from-world matrix (3x3 / 4x4)
    energies: torch.Tensor  # per-iteration masked energy
    final_live: torch.Tensor  # live TSDF under the final pose


def _band_mask(canonical, live, eps=1e-5):
    return ((torch.abs(canonical) < 1.0 - eps) | (torch.abs(live) < 1.0 - eps)).to(
        canonical.dtype
    )


def _normal_step(canonical, live, j, damping):
    """The masked energy and the damped Gauss–Newton step δ from the
    per-voxel Jacobian ``j`` ``(*spatial, k)``."""
    mask = _band_mask(canonical, live)
    e = live - canonical
    energy = 0.5 * torch.sum(mask * e * e)
    k = j.shape[-1]
    jf = j.reshape(-1, k)
    jtj = (mask.reshape(-1, 1) * jf).T @ jf
    jte = jf.T @ (mask * e).reshape(-1)
    eye = torch.eye(k, dtype=j.dtype, device=j.device)
    delta = torch.linalg.solve_ex(jtj + damping * eye, -jte)[0]
    return energy, delta


def _fixed_iterations(canonical, ext, iterations, step) -> tuple:
    """``iterations`` steps ``ext, energy = step(ext)``, the energies kept on
    the device."""
    energies = []
    for _ in range(iterations):
        ext, energy = step(ext)
        energies.append(energy)
    stacked = torch.stack(energies) if energies else canonical.new_zeros(0)
    return ext, stacked


def solve_rigid_2d(
    canonical: torch.Tensor,
    live_depth: torch.Tensor,
    camera: Camera2d,
    grid: GridSpec,
    initial_extrinsic: torch.Tensor | None = None,
    iterations: int = 30,
    damping: float = 1e-6,
    narrow_band_width_voxels: int = 20,
    method: GenerationMethod = GenerationMethod.BASIC,
) -> Sdf2SdfResult:
    """2D (3-DoF: tx, tz, θ) SDF-2-SDF registration on the canonical's
    device."""
    if grid.dim != 2:
        raise ValueError(f"solve_rigid_2d needs a 2D grid, got {grid.shape}")
    device = canonical.device
    if initial_extrinsic is None:
        initial_extrinsic = identity_extrinsic(2, device)
    points = voxel_center_coordinates(grid, device)  # (X, Z, 2) world
    gen = dict(narrow_band_width_voxels=narrow_band_width_voxels, method=method)

    def step(ext):
        live = generate_tsdf_2d(live_depth, camera, grid, extrinsic=ext, **gen)
        # ∇_p Φ in world units (1/m): the array gradient is per voxel.
        grad_p = derivatives.gradient(live) / grid.voxel_size  # (X, Z, 2)
        r = ext[:2, :2]
        grad_q = torch.einsum("ij,...j->...i", r, grad_p)
        # q = R p + t; dq/dθ = dR/dθ p = S R p with S = [[0, -1], [1, 0]].
        q = torch.einsum("ij,...j->...i", r, points) + ext[:2, 2]
        dq_dtheta = torch.stack([-q[..., 1], q[..., 0]], dim=-1)
        j = torch.cat([grad_q, torch.sum(grad_q * dq_dtheta, -1, keepdim=True)], -1)
        energy, delta = _normal_step(canonical, live, j, damping)
        # Left-compose the increment: T ← exp(δ̂) T.
        c, s = torch.cos(delta[2]), torch.sin(delta[2])
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        inc = torch.stack([torch.stack([c, -s, delta[0]]),
                           torch.stack([s, c, delta[1]]),
                           torch.stack([zero, zero, one])])
        return inc @ ext, energy

    ext, energies = _fixed_iterations(canonical, initial_extrinsic.to(canonical.dtype),
                                      iterations, step)
    final_live = generate_tsdf_2d(live_depth, camera, grid, extrinsic=ext, **gen)
    return Sdf2SdfResult(extrinsic=ext, energies=energies, final_live=final_live)


def _hat3(w):
    z = torch.zeros_like(w[0])
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def solve_rigid_3d(
    canonical: torch.Tensor,
    live_depth: torch.Tensor,
    camera: PinholeCamera,
    grid: GridSpec,
    initial_extrinsic: torch.Tensor | None = None,
    iterations: int = 30,
    damping: float = 1e-6,
    narrow_band_width_voxels: int = 20,
    method: GenerationMethod = GenerationMethod.BASIC,
) -> Sdf2SdfResult:
    """3D (6-DoF) SDF-2-SDF registration on the canonical's device."""
    if grid.dim != 3:
        raise ValueError(f"solve_rigid_3d needs a 3D grid, got {grid.shape}")
    device, dtype = canonical.device, canonical.dtype
    if initial_extrinsic is None:
        initial_extrinsic = identity_extrinsic(3, device)
    points = voxel_center_coordinates(grid, device)  # (X, Y, Z, 3) world
    gen = dict(narrow_band_width_voxels=narrow_band_width_voxels, method=method)
    eye3 = torch.eye(3, dtype=dtype, device=device)
    last_row = torch.eye(4, dtype=dtype, device=device)[3:]

    def step(ext):
        live = generate_tsdf_3d(live_depth, camera, grid, extrinsic=ext, **gen)
        grad_p = derivatives.gradient(live) / grid.voxel_size  # (..., 3)
        r = ext[:3, :3]
        grad_q = torch.einsum("ij,...j->...i", r, grad_p)
        q = torch.einsum("ij,...j->...i", r, points) + ext[:3, 3]
        # J = [∇_qΦ | ∇_qΦ · (−[q]×)] = [∇_qΦ | q × ∇_qΦ].
        j = torch.cat([grad_q, torch.linalg.cross(q, grad_q, dim=-1)], dim=-1)
        energy, delta = _normal_step(canonical, live, j, damping)
        # exp of the small twist: Rodrigues on δω, first-order coupling.
        w = delta[3:]
        theta = torch.sqrt(torch.sum(w * w) + 1e-24)
        k = _hat3(w / theta)
        rot = eye3 + torch.sin(theta) * k + (1.0 - torch.cos(theta)) * (k @ k)
        inc = torch.cat([torch.cat([rot, delta[:3, None]], dim=1), last_row])
        return inc @ ext, energy

    ext, energies = _fixed_iterations(canonical, initial_extrinsic.to(dtype), iterations, step)
    final_live = generate_tsdf_3d(live_depth, camera, grid, extrinsic=ext, **gen)
    return Sdf2SdfResult(extrinsic=ext, energies=energies, final_live=final_live)
