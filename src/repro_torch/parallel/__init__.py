# Block-parallel training: every block advances on every batch, each with its
# own AdamW moments; the shared periphery is reconciled by a sync policy
# (engine.py). In one process the engine is round-robin; over a process
# group it is the pod-per-block mesh, one rank per (pod, data) position
# (dist.py).
from repro_torch.parallel.engine import (PERIPHERY_POLICIES,
                                         BlockParallelTrainer,
                                         train_db_parallel)
from repro_torch.parallel.state import (BlockParallelState, block_view,
                                        merge_params, split_periphery,
                                        stack_block_views, uniform_block_size)
