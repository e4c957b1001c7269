"""Shapes shared by the CPU emulation of the bf16 tensor-core attention
backward (``test_torch_attention_bwd_tc.py``) and its card tests
(``test_torch_gpu.py``), so both cover the same ragged and empty-row cases.
Imports nothing, so the card tests stay free of JAX."""

# name -> (kind, Sq, Sk, window, mask_seq): ragged lengths, several 64-row
# tiles; in "two_pass, cut keys" query row 0's one key (S) lies past Sk: it
# sees none
TC_BWD_CASES = {"full": ("full", 100, 190, None, None),
                "causal": ("causal", 200, 200, None, None),
                "window": ("window", 200, 200, 37, None),
                "db_concat": ("db_concat", 260, 260, None, 130),
                "two_pass": ("two_pass", 130, 260, None, 130),
                "two_pass, cut keys": ("two_pass", 130, 100, None, 130)}
