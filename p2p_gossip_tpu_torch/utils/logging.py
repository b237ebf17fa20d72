"""NS_LOG-style component logging (the JAX package's ``utils/logging.py``:
the same components, levels, spec syntax and line format, so a run of
either package under the same ``P2P_LOG`` / ``--log`` prints the same
lines).

The reference gets per-component tracing for free from NS-3
(`NS_LOG_COMPONENT_DEFINE("P2PNode")`, p2pnode.cc:4 / p2pnetwork.cc:15, with
levels selected at run time via the ``NS_LOG`` environment variable). This
module provides the same capability for the framework:

- every module registers a :class:`LogComponent` by name;
- severity names come from NS-3, but the order is deliberately re-ranked to
  the conventional ERROR < WARN < INFO < FUNCTION < LOGIC < DEBUG (NS-3
  places DEBUG *below* INFO; here ``=debug`` is maximum verbosity, ~ALL);
- components/levels are selected either programmatically
  (:func:`enable` / :func:`disable`) or via the ``P2P_LOG`` environment
  variable, whose syntax follows NS_LOG:
  ``P2P_LOG="P2PNode=info:Engine.Sync=logic:*=warn"``;
- messages carry an NS-3-style prefix: ``+<sim time>s [Component] LEVEL:``
  when the caller supplies a simulation time, else ``[Component] LEVEL:``.

Logging calls on disabled components cost one integer compare — cheap enough
to leave in the per-event hot path of the event engine. (The tick engine
logs only at chunk granularity: a per-tick line would read device state on
the host every tick.)
"""

from __future__ import annotations

import os
import sys
from typing import TextIO

# Severity order follows ns3::LogLevel: a component enabled at level L emits
# everything with severity <= L.
LOG_ERROR = 1
LOG_WARN = 2
LOG_INFO = 3
LOG_FUNCTION = 4
LOG_LOGIC = 5
LOG_DEBUG = 6
LOG_ALL = 7

_LEVEL_NAMES = {
    LOG_ERROR: "ERROR",
    LOG_WARN: "WARN",
    LOG_INFO: "INFO",
    LOG_FUNCTION: "FUNCTION",
    LOG_LOGIC: "LOGIC",
    LOG_DEBUG: "DEBUG",
}

_NAME_LEVELS = {name.lower(): lvl for lvl, name in _LEVEL_NAMES.items()}
_NAME_LEVELS["all"] = LOG_ALL
_NAME_LEVELS["level_all"] = LOG_ALL
_NAME_LEVELS["off"] = 0

_REGISTRY: dict[str, "LogComponent"] = {}
# Errors and warnings are visible by default (a silently discarded checkpoint
# or a bad P2P_LOG spec must reach stderr); everything chattier is opt-in.
_DEFAULT_LEVEL = LOG_WARN
_RULES: dict[str, int] = {}  # component (or "*") -> level
_STREAM: TextIO | None = None  # None => sys.stderr at call time
# Engines log simulation time in integer ticks; the CLI maps ticks to seconds
# (NS-3's Time::SetResolution analog) so prefixes read like NS_LOG's "+1.5s".
_TIME_RESOLUTION = 1.0


def _out() -> TextIO:
    return _STREAM if _STREAM is not None else sys.stderr


def parse_level(spec: str) -> int:
    """``"info"`` / ``"LOG_INFO"`` / ``"3"`` -> numeric level."""
    s = spec.strip().lower()
    if s.startswith("log_"):
        s = s[4:]
    if s in _NAME_LEVELS:
        return _NAME_LEVELS[s]
    try:
        return int(s)
    except ValueError:
        raise ValueError(
            f"unknown log level {spec!r}; expected one of "
            f"{sorted(_NAME_LEVELS)} or an integer"
        ) from None


class LogComponent:
    """One named source of log messages (NS_LOG_COMPONENT_DEFINE analog)."""

    __slots__ = ("name", "level")

    def __init__(self, name: str):
        self.name = name
        self.level = _RULES.get(name, _RULES.get("*", _DEFAULT_LEVEL))

    # -- emit ----------------------------------------------------------------
    def _emit(self, severity: int, msg: str, sim_time: float | None) -> None:
        if sim_time is not None:
            prefix = f"+{sim_time * _TIME_RESOLUTION:.9g}s "
        else:
            prefix = ""
        label = _LEVEL_NAMES.get(severity, str(severity))
        print(f"{prefix}[{self.name}] {label}: {msg}", file=_out())

    def log(self, severity: int, msg: str, sim_time: float | None = None) -> None:
        if severity <= self.level:
            self._emit(severity, msg, sim_time)

    def error(self, msg: str, sim_time: float | None = None) -> None:
        self.log(LOG_ERROR, msg, sim_time)

    def warn(self, msg: str, sim_time: float | None = None) -> None:
        self.log(LOG_WARN, msg, sim_time)

    def info(self, msg: str, sim_time: float | None = None) -> None:
        self.log(LOG_INFO, msg, sim_time)

    def function(self, msg: str, sim_time: float | None = None) -> None:
        self.log(LOG_FUNCTION, msg, sim_time)

    def logic(self, msg: str, sim_time: float | None = None) -> None:
        self.log(LOG_LOGIC, msg, sim_time)

    def debug(self, msg: str, sim_time: float | None = None) -> None:
        self.log(LOG_DEBUG, msg, sim_time)

    def enabled(self, severity: int) -> bool:
        """Guard for log lines whose message is expensive to build."""
        return severity <= self.level


def get_logger(name: str) -> LogComponent:
    """Register (or fetch) the component named ``name``."""
    comp = _REGISTRY.get(name)
    if comp is None:
        comp = _REGISTRY[name] = LogComponent(name)
    return comp


def enable(component: str = "*", level: int | str = LOG_INFO) -> None:
    """Enable ``component`` (or every component, with ``"*"``) at ``level``."""
    lvl = parse_level(level) if isinstance(level, str) else level
    _RULES[component] = lvl
    if component == "*":
        for comp in _REGISTRY.values():
            # Explicit per-component rules keep priority over the wildcard.
            if comp.name not in _RULES:
                comp.level = lvl
    else:
        comp = _REGISTRY.get(component)
        if comp is not None:
            comp.level = lvl


def disable(component: str = "*") -> None:
    """Silence ``component`` (even under an active wildcard rule), or
    everything — including components registered later — with ``"*"``."""
    if component == "*":
        _RULES.clear()
        _RULES["*"] = 0
        for comp in _REGISTRY.values():
            comp.level = 0
    else:
        enable(component, 0)


def configure(spec: str) -> None:
    """Apply an NS_LOG-style spec: ``"Comp=level:Comp2=level"``.

    A bare component name enables it at DEBUG (as NS_LOG does with ALL);
    ``*`` applies to every component without an explicit rule.
    """
    for part in spec.split(":"):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            name, _, lvl = part.partition("=")
            enable(name.strip(), parse_level(lvl))
        else:
            enable(part, LOG_DEBUG)


def set_time_resolution(seconds_per_tick: float) -> None:
    """Seconds per simulation-time unit in log prefixes (default 1.0)."""
    global _TIME_RESOLUTION
    _TIME_RESOLUTION = seconds_per_tick


def set_stream(stream: TextIO | None) -> None:
    """Redirect log output (None restores stderr). For tests."""
    global _STREAM
    _STREAM = stream


def _init_from_env() -> None:
    spec = os.environ.get("P2P_LOG")
    if spec:
        try:
            configure(spec)
        except ValueError as e:  # bad spec should not kill the program
            print(f"[Logging] WARN: ignoring P2P_LOG: {e}", file=_out())


_init_from_env()
