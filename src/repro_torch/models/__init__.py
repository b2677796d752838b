"""``repro_torch.models`` — the language models, port of ``repro.models``.

``layers`` (plans, norms, rope, MLP), ``attention`` (flash-chunked GQA),
``ssd`` (the Mamba2 SSD mixer and the FFT-conv mixer) and ``model``
(forward, ``loss_fn`` with remat, prefill, decode).
Parameters are nested dicts of tensors laid out as the reference's;
``repro_torch.weights`` converts the reference's numpy trees.
"""
