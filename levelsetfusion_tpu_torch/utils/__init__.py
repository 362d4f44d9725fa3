"""Experiment configs, telemetry, checkpoints and the debug, profiling and
visualization utilities. A submodule is imported when first used, so the
solvers can import ``utils.profiling`` without importing ``utils.config``,
which imports them."""

import importlib

__all__ = ["checkpoint", "config", "telemetry"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
