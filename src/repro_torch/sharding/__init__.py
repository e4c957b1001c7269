# Mesh rules (port of ``repro.sharding``): the block-parallel half, one
# block per ``pod`` group of ranks. The tensor-parallel rules are not ported.
from repro_torch.sharding.rules import (BLOCK_AXIS, block_parallel_mesh,
                                        check_world)
