"""Per-client link + compute models for the async runtime.

Mirror of ``src/repro/runtime/network.py`` (pure Python, copied as is).

The simulator's ``_Wire`` counts the *actual* bytes each message puts on
the wire (post-filter, so an int8 or NF4 payload is ~4x / ~8x smaller
than fp32). This module converts those byte counts into **simulated
transmission time** per client link, which is how quantization shortens
simulated rounds by a measurable, paper-faithful amount instead of by
assertion.

A :class:`LinkProfile` is (bandwidth, latency, jitter); :data:`PROFILES`
names a few canonical WAN classes (fiber ... satellite) used by the
heterogeneous-federation benchmark. All jitter draws come from a
per-client ``random.Random`` seeded with a string key — CPython seeds
string inputs via SHA-512, so the model is deterministic across
processes without touching ``PYTHONHASHSEED``.
"""
from __future__ import annotations

import dataclasses
from random import Random
from collections.abc import Mapping, Sequence
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LinkProfile:
    """One client's uplink/downlink characteristics."""

    name: str
    bandwidth_mbps: float     # symmetric link rate, megabits per second
    latency_ms: float         # one-way propagation delay
    jitter: float = 0.0       # fractional stddev on transfer time (>= 0)

    def base_seconds(self, nbytes: int) -> float:
        return self.latency_ms / 1e3 + (nbytes * 8.0) / (self.bandwidth_mbps * 1e6)


PROFILES: dict[str, LinkProfile] = {
    "fiber": LinkProfile("fiber", bandwidth_mbps=1000.0, latency_ms=2.0, jitter=0.01),
    "cable": LinkProfile("cable", bandwidth_mbps=200.0, latency_ms=10.0, jitter=0.05),
    "wifi": LinkProfile("wifi", bandwidth_mbps=80.0, latency_ms=5.0, jitter=0.10),
    "lte": LinkProfile("lte", bandwidth_mbps=30.0, latency_ms=40.0, jitter=0.20),
    "dsl": LinkProfile("dsl", bandwidth_mbps=10.0, latency_ms=25.0, jitter=0.08),
    "3g": LinkProfile("3g", bandwidth_mbps=2.0, latency_ms=100.0, jitter=0.30),
    "satellite": LinkProfile("satellite", bandwidth_mbps=25.0, latency_ms=600.0, jitter=0.15),
}


@dataclasses.dataclass(frozen=True)
class ComputeProfile:
    """How long one local-training task takes on a client device."""

    base_seconds: float = 1.0
    jitter: float = 0.0


class NetworkModel:
    """Maps (client, nbytes) -> simulated transfer seconds, deterministically.

    ``profiles`` assigns each client a :class:`LinkProfile`; clients not in
    the mapping use ``default``. Each client owns a seeded RNG stream so
    jitter sequences are independent of scheduling order on *other* links.
    """

    def __init__(
        self,
        profiles: Optional[Mapping[str, LinkProfile]] = None,
        default: Optional[LinkProfile] = None,
        compute: Optional[Mapping[str, ComputeProfile]] = None,
        default_compute: Optional[ComputeProfile] = None,
        seed: int = 0,
    ) -> None:
        self.profiles = dict(profiles or {})
        self.default = default or PROFILES["wifi"]
        self.compute = dict(compute or {})
        self.default_compute = default_compute or ComputeProfile()
        self.seed = seed
        self._rngs: dict[str, Random] = {}

    def _rng(self, client: str) -> Random:
        rng = self._rngs.get(client)
        if rng is None:
            rng = self._rngs[client] = Random(f"link:{self.seed}:{client}")
        return rng

    def link(self, client: str) -> LinkProfile:
        return self.profiles.get(client, self.default)

    def bandwidth_bps(self, client: str) -> float:
        """The client's link rate in bits/s (AdaptiveQuantizeFilter's unit)."""
        return self.link(client).bandwidth_mbps * 1e6

    def _jittered(self, client: str, base: float, jitter: float) -> float:
        if jitter <= 0.0:
            return base
        # 1 + |N(0, jitter)|: transfers only ever slow down, never go
        # faster than the deterministic lower bound — keeps sim times
        # physical and monotone in bytes.
        return base * (1.0 + abs(self._rng(client).gauss(0.0, jitter)))

    def transfer_seconds(self, client: str, nbytes: int) -> float:
        link = self.link(client)
        return self._jittered(client, link.base_seconds(nbytes), link.jitter)

    def compute_seconds(self, client: str) -> float:
        prof = self.compute.get(client, self.default_compute)
        return self._jittered(client, prof.base_seconds, prof.jitter)

    def floor_seconds(self, client: str) -> tuple[float, float]:
        """(min transfer time, min compute time) for ``client`` — hard
        lower bounds regardless of payload size or jitter draw (jitter
        only ever slows transfers down). The scheduler uses these to
        decide whether an in-flight round trip could still produce an
        event earlier than the next queued one."""
        link = self.link(client)
        prof = self.compute.get(client, self.default_compute)
        return link.latency_ms / 1e3, prof.base_seconds


def heterogeneous_network(
    clients: Sequence[str],
    seed: int = 0,
    tiers: Sequence[str] = ("fiber", "cable", "wifi", "lte", "dsl", "3g"),
    compute_base_s: float = 1.0,
    compute_spread: float = 4.0,
) -> NetworkModel:
    """A mixed federation: link tiers round-robin over ``tiers`` and
    compute speeds spread log-uniformly over [base, base*spread] — the
    straggler-heavy regime where async scheduling pays off.
    """
    rng = Random(f"hetero:{seed}")
    profiles = {c: PROFILES[tiers[i % len(tiers)]] for i, c in enumerate(clients)}
    compute = {
        c: ComputeProfile(compute_base_s * compute_spread ** rng.random(), jitter=0.1)
        for c in clients
    }
    return NetworkModel(profiles, compute=compute, seed=seed)


def _link_from_spec(value) -> LinkProfile:
    """A named WAN class ("fiber") or an inline profile dict."""
    if isinstance(value, str):
        return PROFILES[value]
    return LinkProfile(
        name=value.get("name", "custom"),
        bandwidth_mbps=float(value["bandwidth_mbps"]),
        latency_ms=float(value.get("latency_ms", 10.0)),
        jitter=float(value.get("jitter", 0.0)),
    )


def network_from_spec(spec: Mapping, clients: Sequence[str]) -> NetworkModel:
    """Build a NetworkModel from a declarative job-spec dict.

    Two shapes::

        {"kind": "hetero", "tiers": ["fiber", "3g"], "compute_base_s": 1.0,
         "compute_spread": 4.0, "seed": 0}

        {"default": "wifi",
         "profiles": {"site-0": "fiber",
                      "site-1": {"bandwidth_mbps": 5, "latency_ms": 80}},
         "compute": {"site-0": 0.5}, "compute_base_s": 1.0,
         "compute_jitter": 0.0, "seed": 0}

    Link values are canonical :data:`PROFILES` names or inline dicts.
    """
    spec = dict(spec)
    seed = int(spec.get("seed", 0))
    if spec.get("kind") == "hetero":
        kwargs = {
            k: spec[k]
            for k in ("tiers", "compute_base_s", "compute_spread")
            if k in spec
        }
        if "tiers" in kwargs:
            kwargs["tiers"] = tuple(kwargs["tiers"])
        return heterogeneous_network(clients, seed=seed, **kwargs)
    jitter = float(spec.get("compute_jitter", 0.0))
    return NetworkModel(
        profiles={c: _link_from_spec(v) for c, v in spec.get("profiles", {}).items()},
        default=_link_from_spec(spec.get("default", "wifi")),
        compute={
            c: ComputeProfile(float(v), jitter=jitter)
            for c, v in spec.get("compute", {}).items()
        },
        default_compute=ComputeProfile(float(spec.get("compute_base_s", 1.0)), jitter=jitter),
        seed=seed,
    )
