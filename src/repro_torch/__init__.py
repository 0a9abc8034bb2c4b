"""PyTorch/CUDA port of the foresight skiplist (``repro``'s JAX package).

Same module names as ``repro`` so each piece has an obvious counterpart:
``core.skiplist`` (state, build, eager search), ``core.prng`` (threefry
tower-height bits), ``kernels.ref`` (search oracles), ``kernels.
foresight_traverse`` (the traversal kernels and their plain versions),
``kernels.ops`` (batched lookup through the kernels) and ``convert``
(state exchange with ``repro`` as numpy arrays).

The package imports torch and numpy only.  State-creating entry points run
on the GPU unless the caller passes ``device="cpu"``.
"""
