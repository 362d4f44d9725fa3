"""Where does the fused gradient kernel's time go? Time per kernel call with
energy terms switched off.

Port of ``experiments/fused_ablation.py``: the five cases at 128³, rate 0.1,
γ 0.1, band union, the warp's standard-normal field × 0.5 from seed 0. Each
case chains ``n2`` and ``n1`` calls, each feeding its new warp to the next,
and reports (t(n2) − t(n1)) / (n2 − n1) in ms per call, as the JAX script
does. Prints ``{"shape", "device", "ms_per_kernel_call": {...}}``.

    python -m levelsetfusion_tpu_torch.experiments.fused_ablation
"""

from __future__ import annotations

import json

import numpy as np
import torch

from levelsetfusion_tpu_torch.experiments._timing import (
    device_name,
    differenced_ms,
    resolve_device,
)
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import (
    fused_gradient_update,
    sobolev_taps,
)

SHAPE = (128, 128, 128)
N1, N2 = 4, 44


def cases(taps) -> dict:
    return {
        "full(kill+ls+sob)": dict(w_smooth=0.1, w_ls=0.1, killing=True, taps=taps),
        "no_sobolev": dict(w_smooth=0.1, w_ls=0.1, killing=True, taps=()),
        "no_levelset": dict(w_smooth=0.1, w_ls=0.0, killing=True, taps=taps),
        "tikhonov": dict(w_smooth=0.1, w_ls=0.1, killing=False, taps=taps),
        "data_only": dict(w_smooth=0.0, w_ls=0.0, killing=False, taps=()),
    }


def main(device="cuda", shape=SHAPE, n1=N1, n2=N2) -> dict:
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    base = rng.standard_normal(shape).astype(np.float32)
    canonical = torch.from_numpy(np.tanh(base * 0.4)).to(device)
    warped = torch.from_numpy(np.tanh(np.roll(base, 1, 0) * 0.4)).to(device)
    warp_cm = torch.from_numpy(
        (rng.standard_normal((3,) + tuple(shape)) * 0.5).astype(np.float32)
    ).to(device)
    rate = torch.tensor(0.1, device=device)

    per_call = {}
    for name, kw in cases(sobolev_taps(7, 0.1)).items():
        def chain(n, kw=kw):
            w = warp_cm
            for _ in range(n):
                w, _ = fused_gradient_update(warped, canonical, w, rate,
                                             band_union=True, gamma=0.1, **kw)
            return w

        per_call[name] = differenced_ms(lambda: chain(n2), lambda: chain(n1),
                                        n2 - n1, device, repeats=3)
    out = {"shape": list(shape), "device": device_name(device),
           "ms_per_kernel_call": per_call}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
