"""``repro_torch.comm`` — the ownership swap over ``torch.distributed``
and the cost model's method choice."""
