"""PyTorch / CUDA port of the WMD engine (the JAX package ``repro`` is the
reference it is held against).

The main path is staged exact top-k retrieval,
``WmdEngine.search(queries, k, prune="rwmd")``, over an index frozen by
``build_index``. Its two kernels are written by hand for Hopper
(``kernels/csrc/*.cu``); everything around them is plain PyTorch.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
