"""The port's twins of the repository's ``experiments/`` scripts, one module
per script at the same file name, each run as
``python -m levelsetfusion_tpu_torch.experiments.<name>`` (on a CUDA device;
``device="cpu"`` runs the plain torch versions, for the tests).

Ported so far: the design experiments of the fused gradient kernel —

- ``mxu_conv``: the Sobolev y+z convolution as a stencil against a banded
  matrix product on the tensor cores (``csrc/conv_yz.cu``);
- ``fused_io_probe``: the fused kernel's I/O plan with stand-in bodies
  (``csrc/fused_io_probe.cu``);
- ``dma_probe``: haloed windows staged as an x-walking ring of TMA copies
  (``csrc/dma_probe.cu``); ``dma_probe_sweep`` (GPU only) times its
  variants;
- ``fused_ablation`` and ``fused_gradient_bench``: the fused gradient kernel
  (``ops/kernels/fused_gradient.py``) timed with energy terms switched off,
  and against the plain torch stencil step;
- ``fused_gradient_sweep`` (no script of its own): variants of the fused
  gradient's CUDA source, each kernel timed (GPU only);

and the resample's design space, the clamped (±2) shift-enumeration form of
the resample (its plain version ``resample_variants.shift_sum_reference``) —

- ``resample_variants``: per-step windows (``run_variant``), rows staged
  once per x chunk (``run_vmemfull``) and tents once per voxel (``run_v7``)
  under four loop structures, with timing-only bodies
  (``csrc/resample_variants.cu``);
- ``v10_xslab``: x-row slabs whose pair loop runs over the active shift
  range only (``csrc/v10_xslab.cu``);

and the cost bisections of that resample on a stack that is already
materialised (``csrc/stack_bodies.cu``, one kernel for both; the plain
version of every body is ``loop_cost.stack_body_reference``) —

- ``loop_cost``: five bodies under a runtime pair loop or a static unroll;
- ``bisect_kernel``: the production body's features added back one at a
  time (``run``), and its weights computed once per voxel (``run_v8``).

Each kernel's wrapper sits beside its plain torch version (``*_reference``)
in the module of its script, and counts its launches in a module-level
counter.
"""
