"""FL message types: 'Task Data' (server -> clients) and 'Task Result'

(clients -> server), the two payloads of one federated round (paper §II-A).
A message's ``payload`` is a flat state dict of arrays — or of
:class:`~repro_torch.core.quantization.QuantizedTensor` once a quantize filter
has run. ``headers`` carry workflow metadata (round number, client name,
sample counts, timing) and are never quantized.
"""
from __future__ import annotations

import dataclasses
import enum
from collections.abc import Mapping
from typing import Any

from repro_torch.utils.trees import tree_bytes


class MessageKind(enum.Enum):
    TASK_DATA = "task_data"       # server -> client (global weights)
    TASK_RESULT = "task_result"   # client -> server (local update)


@dataclasses.dataclass
class Message:
    kind: MessageKind
    payload: dict[str, Any]
    headers: dict[str, Any] = dataclasses.field(default_factory=dict)

    def payload_bytes(self) -> int:
        """Logical tensor-payload size: raw array/QuantizedTensor bytes
        only. This is **not** bytes-on-wire — it excludes item framing,
        pipeline envelopes, chunk headers and the transmitted message
        headers; the simulator's
        :class:`~repro_torch.fl.simulator.TrafficStats` counts those at the
        driver, which is where true wire totals come from."""
        total = 0
        for v in self.payload.values():
            if hasattr(v, "total_bytes"):
                total += v.total_bytes  # QuantizedTensor
            else:
                total += tree_bytes(v)
        return total

    def replace_payload(self, payload: Mapping[str, Any]) -> Message:
        return Message(self.kind, dict(payload), dict(self.headers))
