"""PyTorch/CUDA port of the foresight skiplist (``repro``'s JAX package).

Same module names as ``repro`` so each piece has an obvious counterpart:
``core.skiplist`` (state, build, eager search, insert / delete /
``apply_ops``), ``core.prng`` (threefry tower-height bits),
``core.validated`` (Optimistic Validation), ``core.versioned`` (versions
and mixed-view reads), ``kernels.ref`` (search oracles), ``kernels.
foresight_traverse`` and ``kernels.validated_traverse`` (the traversal
kernels and their plain versions), ``kernels.ops`` (batched lookup through
the kernels), ``core.sharded`` and ``core.rebalance_traced`` (range
shards, their rebalancing on the host and in place), ``core.mesh_index``,
``launch.mesh`` and ``kernels.mesh_launch`` (the index across the devices
of a ``torch.distributed`` mesh), ``data.store`` and ``data.pipeline``
(the skiplist-indexed sample store and its deterministic pipeline),
``serving.kvcache`` and ``serving.watchdog`` (the paged KV cache's page
table and its invariant checks), ``runtime.chaos`` and ``runtime.ft``
(fault injection and fault tolerance, numpy only), ``models.layers``,
``models.moe``, ``models.mamba``, ``models.rwkv6`` and
``models.transformer`` (the LLM substrate: every family's forward,
prefill and decode, bf16 with fp32 accumulation), ``configs`` (the ten
architectures and their smoke configs), ``serving.engine`` (the
continuous-batching ``ServeEngine`` over the session skiplist, the page
table, the watchdog and the chaos injector), ``optim.adamw`` (AdamW),
``checkpoint.manager`` (atomic checkpoints on the reference's on-disk
layout), ``parallel.sharding`` and ``parallel.decode_attn`` (the
sharding policy's specs and the sequence-sharded decode attention),
``train.step`` (the train, prefill and decode step factories),
``launch.mesh`` (the model and index meshes), ``launch.serve``,
``launch.serve_lm``, ``launch.quickstart``, ``launch.index_service``,
``launch.train`` and ``launch.train_lm`` (the entry points, twins of
``launch/serve.py``, ``launch/train.py`` and the examples) and
``convert`` (state, param, cache, optimizer-state and train-state
exchange with ``repro`` as numpy arrays).

Training on the CPU::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \
        --steps 25 --global-batch 4 --seq-len 32 --ckpt-dir "$(mktemp -d)" \
        --ckpt-every 10 --fail-at 15
    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu

and on the card the same without ``--device cpu``.

The package imports torch and numpy only.  State-creating entry points run
on the GPU unless the caller passes ``device="cpu"``; random numbers come
from an explicit ``torch.Generator``.
"""
