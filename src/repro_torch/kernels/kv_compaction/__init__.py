from repro_torch.kernels.kv_compaction.ops import compact_kv_pool  # noqa: F401
