from repro_torch.checkpoint.ckpt import (CheckpointCorrupt, CheckpointError,
                                         CheckpointManager, copy_into,
                                         file_sha256, load_block_opt,
                                         load_blocks, load_metadata,
                                         load_pytree, rng_from_json,
                                         rng_to_json, save_block,
                                         save_block_opt, save_block_view,
                                         save_pytree,
                                         tree_digest)
