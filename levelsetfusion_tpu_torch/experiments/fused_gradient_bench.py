"""The fused gradient kernel against the plain torch stencil step.

Port of ``experiments/fused_gradient_bench.py``. The JAX script's "XLA
stencil step" is here the plain torch step of the port's golden ops
(``ops/derivatives.py``, ``ops/terms.py``, ``ops/sobolev.py``): data,
Killing (γ 0.1, weight 0.1) and level-set (weight 0.1) gradients, the 7-tap
Sobolev filter, u − rate·g. Then four variants through
``fused_gradient_update``, and the ratio of the full one to the plain step.
Each time is per iteration, from chains of ``n2`` and ``n1`` iterations
differenced, as in the JAX script.

    python -m levelsetfusion_tpu_torch.experiments.fused_gradient_bench
"""

from __future__ import annotations

import numpy as np
import torch

from levelsetfusion_tpu_torch.experiments._timing import (
    device_name,
    differenced_ms,
    resolve_device,
)
from levelsetfusion_tpu_torch.ops import sobolev, terms
from levelsetfusion_tpu_torch.ops.derivatives import gradient
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import (
    fused_gradient_update,
    sobolev_taps,
    to_component_major,
)

SHAPE = (128, 128, 128)
N1, N2 = 4, 44


def _fields(shape, device):
    """The JAX script's inputs: TSDF-like fields and a (*shape, 3) warp × 0.5
    from seed 0."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal(shape).astype(np.float32)
    canonical = np.tanh(base * 0.4)
    warped = np.tanh(np.roll(base, 1, axis=0) * 0.4)
    warp = (rng.standard_normal(tuple(shape) + (3,)) * 0.5).astype(np.float32)
    return [torch.from_numpy(v).to(device) for v in (canonical, warped, warp)]


def plain_step(warped, canonical, warp, rate, kernel):
    """One solver step of plain torch ops on a (*shape, 3) warp."""
    wg = gradient(warped)
    g_data, _ = terms.data_term(warped, canonical, wg)
    total = g_data
    g_s, _ = terms.killing_term(warp, 0.1)
    total = total + 0.1 * g_s
    g_ls, _ = terms.level_set_term(warped, wg, canonical)
    total = total + 0.1 * g_ls
    total = sobolev.convolve_with_sobolev_kernel(total, kernel, 3)
    return warp - rate * total


VARIANTS = {
    "data only": dict(w_smooth=0.0, w_ls=0.0, killing=False, full=False),
    "data+killing": dict(w_smooth=0.1, w_ls=0.0, killing=True, full=False),
    "data+killing+ls": dict(w_smooth=0.1, w_ls=0.1, killing=True, full=False),
    "full(+sobolev)": dict(w_smooth=0.1, w_ls=0.1, killing=True, full=True),
}


def main(device="cuda", shape=SHAPE, n1=N1, n2=N2) -> dict:
    device = resolve_device(device)
    canonical, warped, warp = _fields(shape, device)
    warp_cm = to_component_major(warp)
    rate = torch.tensor(0.3, device=device)
    kernel = torch.from_numpy(sobolev.generate_1d_sobolev_kernel(7, 0.1)).to(device)
    taps = sobolev_taps(7, 0.1)

    def plain_chain(n):
        w = warp
        for _ in range(n):
            w = plain_step(warped, canonical, w, rate, kernel)
        return w

    def fused_chain(n, w_smooth, w_ls, killing, full):
        w = warp_cm
        for _ in range(n):
            w, _ = fused_gradient_update(
                warped, canonical, w, rate, w_data=1.0, gamma=0.1, band_union=True,
                w_smooth=w_smooth, w_ls=w_ls, killing=killing,
                taps=taps if full else (),
            )
        return w

    def per_iter(chain):
        return differenced_ms(lambda: chain(n2), lambda: chain(n1), n2 - n1, device,
                              repeats=3)

    t_plain = per_iter(plain_chain)
    print(f"plain torch step:    {t_plain:8.3f} ms  [{device_name(device)}]")
    out = {"shape": list(shape), "device": device_name(device),
           "plain_step_ms": t_plain, "ms": {}}
    for name, kw in VARIANTS.items():
        t = per_iter(lambda n, kw=kw: fused_chain(n, **kw))
        out["ms"][name] = t
        extra = ""
        if kw["full"]:
            out["full_speedup_vs_plain"] = t_plain / t
            extra = f"   ({t_plain / t:.2f}x vs plain)"
        print(f"{name:20s} {t:8.3f} ms{extra}")
    return out


if __name__ == "__main__":
    main()
