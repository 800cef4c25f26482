"""Native (C++) runtime components and their Python bindings.

The port keeps its own copy of the C++ source (``store.cc``, a copy of the
JAX package's ``src/store/tpustore.cc``); compiled artifacts land in
``ray_tpu_torch/native/_lib/`` (gitignored), never in the JAX package's
library directory. Libraries are (re)built on demand with g++ — see
:mod:`ray_tpu_torch.native.build`.
"""
