"""PyTorch/CUDA port of the MONO near-duplicate text aligner.

A second package beside the JAX reference ``repro``; its module paths
mirror ``src/repro/`` one to one.  The host stages (hashing, ICWS, key
generation, partitioning, the columnar build, the store, grouping and run
extraction) are NumPy copies of the reference, bit-identical by
construction; the device plan is torch on an explicit device, and its
kernels (the arena probe, the small-group sweep and, when pinned, the ICWS
sketch) are hand-written CUDA for Hopper, as are the min-hash and ICWS
grid kernels behind :mod:`repro_torch.kernels.ops`.  Entry point:
:class:`repro_torch.api.Aligner`.
"""
