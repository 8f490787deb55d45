"""PyTorch + CUDA port of the DVBP reproduction (``repro``).

The JAX package ``repro`` is the reference; this package is the port for
an NVIDIA H100, held against it op for op.  It imports ``torch`` and numpy
and nothing of JAX or ``repro``.  Subpackages mirror the reference:

    kernels/  the placement select and the event-blocked replay
              megakernel: constants, plain versions, CUDA kernels
    core/     instance types, predictions, Eq.(1) bound, the item
              classifiers, the replay (per event and blocked)
    data/     synthetic Azure-like / Huawei-like suites, Azure CSV loader
    sweep/    batching, the batched runner, grids, the result store, CLI

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; CUDA without a card raises.
"""
