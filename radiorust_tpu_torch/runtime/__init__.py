"""Dynamic streaming runtime (port of the JAX package's ``runtime``).

The compiled-step path (``blocks/base.py``) runs static chains on the
device.  This package provides the reference's *dynamic* dataflow on top
of it — live (re)connectable producer/consumer blocks exchanging Signal
messages over capacity-1 broadcast channels with backpressure
(``src/flow.rs``, ``src/sync/broadcast_bp.rs``) — so applications that
need runtime rewiring, elastic buffering, or hardware I/O keep the
reference's semantics while every chunk's math still runs on the device
through the same bound blocks (one compiled step per binding).
``serve_recycling`` serves a stream across worker processes of bounded
lifetime, each resuming the last one's checkpoint.
"""

from .flow import (Receiver, ReceiverConnector, Sender, SenderConnector,
                   new_receiver, new_sender)
from .blocks import (Blackhole, Buffer, FileSink, ArraySink, ArraySource,
                     KeyerSource, MapSignal, Rechunker, RuntimeBlock,
                     RuntimeGraph, Silence, wait_until)
from .recycle import serve_recycling
