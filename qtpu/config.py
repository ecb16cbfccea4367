"""Configuration system: one dataclass tree, JSON round-trip, CLI overrides.

Reference capability: per-daemon getopt flags + compile-time constants in
``definitions/defaultdefinitions.h`` (SURVEY.md §3 #18, §6.6).  This framework
centralizes them: defaults reproduce the BASELINE configs; any leaf can be
overridden with ``--set dotted.path=value``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from qtpu.chain import ChainConfig
from qtpu.pipeline import PipelineConfig

__all__ = ["RunConfig", "load_config", "apply_overrides", "to_dict"]


@dataclasses.dataclass(frozen=True)
class SourceConfig:
    """Entangled-pair source simulation parameters (hardware stand-in)."""

    pair_rate_hz: float = 200_000.0
    window_s: float = 0.05
    offset_ns: float = 13_337.5
    jitter_ns: float = 0.6
    eta_alice: float = 0.9
    eta_bob: float = 0.85
    dark_rate_hz: float = 2_000.0
    error_rate: float = 0.02
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class RunConfig:
    chain: ChainConfig = dataclasses.field(default_factory=ChainConfig)
    source: SourceConfig = dataclasses.field(default_factory=SourceConfig)
    session_seed: int = 0x5E55
    num_windows: int = 20
    metrics_path: str = ""           # "" = stderr
    checkpoint_path: str = ""        # "" = no checkpointing
    keystore_path: str = ""          # "" = no final-key artifact (type-7 analog)


def to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def _from_dict(cls, data: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(f.type) or f.name in ("chain", "pipeline", "source"):
            sub = {"chain": ChainConfig, "pipeline": PipelineConfig,
                   "source": SourceConfig}[f.name]
            kwargs[f.name] = _from_dict(sub, v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def load_config(path: str | None) -> RunConfig:
    if not path:
        return RunConfig()
    with open(path) as f:
        return _from_dict(RunConfig, json.load(f))


def apply_overrides(cfg: RunConfig, overrides: list[str]) -> RunConfig:
    """Apply ``dotted.path=value`` overrides (values parsed as JSON, falling
    back to string)."""
    data = to_dict(cfg)
    for ov in overrides:
        path, _, raw = ov.partition("=")
        if not _:
            raise ValueError(f"override {ov!r} must be path=value")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        node = data
        parts = path.split(".")
        for p in parts[:-1]:
            node = node[p]
        if parts[-1] not in node:
            raise KeyError(f"unknown config key {path!r}")
        node[parts[-1]] = value
    return _from_dict(RunConfig, data)
