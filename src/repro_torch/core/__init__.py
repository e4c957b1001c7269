"""Block partitioning, EDM preconditioning and the DiffusionBlocks sampler."""
