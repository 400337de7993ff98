"""Client-side Executors (paper §II-A): receive Task Data, run the local

computation, return a Task Result. :class:`TrainExecutor` adapts any
``train_fn(params, round) -> (params, num_samples, metrics)`` — the
"client API" surface: the training script needs zero knowledge of
filters, quantization or streaming.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any

from repro_torch.core.messages import Message, MessageKind


class Executor:
    name: str = "executor"

    def execute(self, task: Message) -> Message:
        raise NotImplementedError


TrainFn = Callable[[dict[str, Any], int], tuple[dict[str, Any], int, dict[str, float]]]


class TrainExecutor(Executor):
    def __init__(self, name: str, train_fn: TrainFn) -> None:
        self.name = name
        self.train_fn = train_fn

    def execute(self, task: Message) -> Message:
        rnd = int(task.headers.get("round", 0))
        new_params, num_samples, metrics = self.train_fn(task.payload, rnd)
        return Message(
            MessageKind.TASK_RESULT,
            dict(new_params),
            headers={
                "round": rnd,
                "client": self.name,
                "num_samples": num_samples,
                "metrics": metrics,
            },
        )


class EvalExecutor(Executor):
    """Evaluation-only client: returns metrics, no weights."""

    def __init__(
        self, name: str, eval_fn: Callable[[dict[str, Any], int], dict[str, float]]
    ) -> None:
        self.name = name
        self.eval_fn = eval_fn

    def execute(self, task: Message) -> Message:
        rnd = int(task.headers.get("round", 0))
        metrics = self.eval_fn(task.payload, rnd)
        return Message(
            MessageKind.TASK_RESULT,
            {},
            headers={"round": rnd, "client": self.name, "num_samples": 0, "metrics": metrics},
        )
