"""``repro_torch.models`` — the language models, port of ``repro.models``.

``layers`` (plans, norms, rope, MLP), ``attention`` (flash-chunked GQA,
MLA, Ulysses), ``ssd`` (the Mamba2 SSD mixer and the FFT-conv mixer),
``griffin`` (the RG-LRU), ``moe`` (the MoE feed-forward, expert-parallel
on a mesh) and ``model`` (forward, ``loss_fn`` with remat, prefill,
decode; on one rank or a rank's blocks of a mesh).
Parameters are nested dicts of tensors laid out as the reference's;
``repro_torch.weights`` converts the reference's numpy trees.
"""
