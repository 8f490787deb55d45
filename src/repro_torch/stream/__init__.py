"""repro_torch.stream - bounded-memory streamed replay: full-length traces
in O(alive) memory; the port's ``repro.stream``.

The in-memory sweep materializes every instance as one padded ``(L, 2
n_max)`` event tensor plus ``n_max`` item rows, so memory grows with the
trace's length.  This package replays the same event stream in
fixed-geometry chunks against the same carried state:

  * ``events`` - request sources (in-memory instances, the line-by-line
    Azure CSV reader, a synthetic generator) and ``ChunkedWorkload``, the
    host-side merge and row-pool builder;
  * ``replay`` - ``replay_stream``, the chunk driver with the next chunk
    staged on a second CUDA stream (``prefetch=1``), and ``replay_chunked_events`` for
    pre-materialized event arrays.

Results equal ``core.torchsim.simulate`` on the materialized instance bit
for bit, per event and blocked (tests/test_torch_stream.py holds them to
the JAX package's ``repro.stream``).
"""
from .events import (POOL_SENTINEL, ChunkedWorkload, CsvSource, EventChunk,
                     InstanceSource, StreamMeta, chunk_instance_events,
                     synthetic_source)
from .replay import StreamResult, replay_chunked_events, replay_stream

__all__ = [
    "ChunkedWorkload", "CsvSource", "EventChunk", "InstanceSource",
    "POOL_SENTINEL", "StreamMeta", "StreamResult",
    "chunk_instance_events", "replay_chunked_events", "replay_stream",
    "synthetic_source",
]
