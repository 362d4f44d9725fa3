"""The plain reference that decides ``correct``: TSDF generation, the warp
solve with its energy terms, Sobolev filter, rate halving and stop rule,
the resample and the fusion's blend, in plain PyTorch from the published
definitions (KillingFusion, CVPR 2017; SobolevFusion, RSS 2018) as the
configuration files state them. It imports nothing of the program and takes
nothing the program made; ``dtype`` float32 is the reference, bfloat16 the
control (the next precision below the configuration's float32)."""
