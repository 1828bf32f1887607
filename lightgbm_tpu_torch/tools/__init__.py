"""The port's counterparts of the repository's ``tools/`` probes, run as
``python -m lightgbm_tpu_torch.tools.<name>``: ``profile_pallas_ov``
(the per-launch cost of a small kernel: eager, from C, in a CUDA graph),
``profile_step_cost`` (the cost of a block, a shared-memory access, an
asynchronous copy and a barrier wait) and ``profile_legacy`` (the
partition-bisection scenarios: block copies, the dense partition, the
in-place carry-window compaction, the in-place window step), with the
timing helpers of ``profile_lib``.  Each runs on the card unless given
``--device cpu``, which runs the kernels' plain versions."""
