"""Leveled logger.

Analog of the reference's pic_logger global singleton with its level ladder
debug < verbose < info < performance < warning < error < knowledge
(/root/reference/src/io/mqc_config_adapter.f90:351-379). `performance` is a
dedicated level for timing lines; `knowledge` prints a fact at exit — both
kept for behavioral parity.
"""

from __future__ import annotations

import sys
import time

LEVELS = {
    "debug": 10,
    "verbose": 15,
    "info": 20,
    "performance": 25,
    "warning": 30,
    "error": 40,
    "knowledge": 50,
}


class Logger:
    def __init__(self, level: str = "info", stream=None):
        self.set_level(level)
        self.stream = stream or sys.stdout

    def set_level(self, level: str) -> None:
        self.level = LEVELS.get(level.strip().lower(), LEVELS["info"])

    def _log(self, level: str, msg: str) -> None:
        if LEVELS[level] >= self.level:
            print(f"[{level.upper():<11}] {msg}", file=self.stream)

    def debug(self, msg):
        self._log("debug", msg)

    def verbose(self, msg):
        self._log("verbose", msg)

    def info(self, msg):
        self._log("info", msg)

    def performance(self, msg):
        self._log("performance", msg)

    def warning(self, msg):
        self._log("warning", msg)

    def error(self, msg):
        self._log("error", msg)


#: global singleton (reference: pic_logger global_logger)
global_logger = Logger()


class Timer:
    """Start/stop wall timer (pic_timer analog), usable as a context manager
    that emits a `performance`-level line."""

    def __init__(self, label: str = "", logger: Logger = None):
        self.label = label
        self.logger = logger or global_logger
        self.start_time = None
        self.elapsed = 0.0

    def start(self):
        self.start_time = time.perf_counter()
        return self

    def stop(self) -> float:
        if self.start_time is not None:
            self.elapsed += time.perf_counter() - self.start_time
            self.start_time = None
        return self.elapsed

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        if self.label:
            self.logger.performance(f"{self.label}: {self.elapsed:.3f} s")


_KNOWLEDGE = (
    "The Many-Body Expansion truncated at order N is exact for any system "
    "whose energy has no (N+1)-body or higher terms.",
    "Mulliken charges are basis-dependent: the same molecule in a bigger "
    "basis can show very different partial charges.",
    "The inclusion-exclusion principle was already known to de Moivre in "
    "1718 — GMBE just applies it to overlapping molecular fragments.",
    "Fermi smearing at 300 K changes closed-shell energies by less than "
    "1e-10 Hartree when the HOMO-LUMO gap exceeds 1 eV.",
)


def get_knowledge() -> str:
    """A parting fact (reference: app/main.f90:130 whimsy, kept)."""
    return _KNOWLEDGE[int(time.time()) % len(_KNOWLEDGE)]
