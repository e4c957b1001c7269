"""Shapes shared by the CPU emulations of the tensor-core attention kernels
(``test_torch_attention_bwd_tc.py``, ``test_torch_attention_tf32.py``) and
their card tests (``test_torch_gpu.py``), so both cover the same ragged and
empty-row cases. Imports nothing, so the card tests stay free of JAX."""

# name -> (kind, Sq, Sk, window, mask_seq): ragged lengths, several 64-row
# tiles; in "two_pass, cut keys" query row 0's one key (S) lies past Sk: it
# sees none
TC_BWD_CASES = {"full": ("full", 100, 190, None, None),
                "causal": ("causal", 200, 200, None, None),
                "window": ("window", 200, 200, 37, None),
                "db_concat": ("db_concat", 260, 260, None, 130),
                "two_pass": ("two_pass", 130, 260, None, 130),
                "two_pass, cut keys": ("two_pass", 130, 100, None, 130)}

# the fp32 tensor-core forward at S = 1000 (sixteen 64-key tiles, the last
# 40 keys long), plus the cut-keys case whose query row 0 sees no key
TF32_FWD_CASES = {"full": ("full", 1000, 1000, None, None),
                  "causal": ("causal", 1000, 1000, None, None),
                  "window": ("window", 1000, 1000, 200, None),
                  "db_concat": ("db_concat", 1000, 1000, None, 500),
                  "two_pass": ("two_pass", 500, 1000, None, 500),
                  "two_pass, cut keys": ("two_pass", 130, 100, None, 130)}
