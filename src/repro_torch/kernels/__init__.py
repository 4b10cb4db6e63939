"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside a plain
PyTorch version of the same function.  Sources live in ``../csrc``; they
are compiled with ``nvcc`` at first use (:mod:`._build`) and bound with
``ctypes``.

The package exports the sketch entry points the reference's
``repro/kernels/__init__.py`` exports.  As there, the name
``minhash_sketch`` is the function; the module of the same name (its
``launches`` counter, its plain version) is
``importlib.import_module("repro_torch.kernels.minhash_sketch")``.
"""

from .icws_hash import icws_hash_grid, icws_sketch, icws_sketch_batch
from .ops import (cws_sketch, cws_sketch_batch, icws_token_params,
                  multiset_sketch)
from .minhash_sketch import minhash_sketch   # shadows the module name

__all__ = ["cws_sketch", "cws_sketch_batch", "multiset_sketch",
           "icws_token_params", "icws_hash_grid", "icws_sketch",
           "icws_sketch_batch", "minhash_sketch"]
