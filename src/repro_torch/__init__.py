"""PyTorch + CUDA port of the DVBP reproduction (``repro``).

The JAX package ``repro`` is the reference; this package is the port for
an NVIDIA H100, held against it op for op.  It imports ``torch`` and numpy
and nothing of JAX or ``repro``.  Subpackages mirror the reference:

    kernels/      the placement select, the event-blocked replay
                  megakernel, the legacy scorer, attention and RWKV6:
                  constants, plain versions, CUDA kernels
    core/         instance types, predictions, Eq.(1) bound, the host
                  algorithm zoo, the exact oracle engine (``run``), the
                  item classifiers, the replay (per event and blocked)
    data/         synthetic Azure-like / Huawei-like suites, Azure CSV
                  loader
    sweep/        batching, the batched runner, grids, the result store,
                  CLI
    consolidate/  the consolidation planner, the chunked replay and the
                  consolidating oracle
    obs/          spans, counters, replay decision traces, exporters, the
                  ``obs`` CLI
    resilience/   fault seams, the degradation ladder, checkpoint and
                  resume, input validation
    stream/       the bounded-memory chunked replay of full traces
    cluster/      job->host placement with failure re-entry
    serving/      the DVBP request scheduler, replica engines, the fleet
    models/, configs/, launch/   the model stack and the serving launcher

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; CUDA without a card raises.
"""
