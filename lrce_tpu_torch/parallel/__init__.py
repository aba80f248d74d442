"""Training and evaluation across ranks: one process per card over
``torch.distributed``, the counterpart of ``lrce_tpu/parallel/``.

  - ``mesh.py``: the process group (``init_distributed``), the ("data",
    "fsdp", "model") mesh, each rank's ``Layout`` and the spawner;
  - ``sharding.py``: which parameter splits where (lrce_tpu's rules on the
    port's names) and ``shard_model``: DDP, FSDP (``fully_shard``) and
    tensor parallelism; whole state dicts in and out of a sharded model;
  - ``tensor_parallel.py``: Megatron column / row parallelism by hand;
  - ``dryrun.py``: one train and one eval step over n ranks.

``lrce_tpu/parallel/swin_shard.py`` has no counterpart. It exists because
GSPMD cannot repartition a ``pallas_call``'s operands, so lrce_tpu runs the
Swin tower under ``shard_map`` by hand. Here each rank runs the whole Swin
tower, with every CUDA kernel, on its own clips, and DDP (or, under FSDP,
``sharding.sync_manual_grads``) averages its gradients over the batch
ranks. Drop-path and dropout draw per rank from the agent's generator,
seeded with the batch rank folded in, as ``swin_shard.py`` folds the shard
index into its key.
"""
