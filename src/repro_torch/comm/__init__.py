"""``repro_torch.comm`` — the ownership swap over ``torch.distributed``
(:mod:`.strategies`), the cost model and ``comm='auto'`` selector
(:mod:`.cost`), and compute/communication overlap (:mod:`.overlap`)."""
