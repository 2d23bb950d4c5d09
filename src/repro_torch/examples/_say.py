"""Printing that also keeps what was printed, for the examples' results."""
from __future__ import annotations

from typing import List


class Say:
    """``say(line)`` prints ``line`` (when ``verbose``) and keeps it;
    ``text`` is every line kept, as print would have written them."""

    def __init__(self, verbose: bool = True):
        self.verbose = verbose
        self.lines: List[str] = []

    def __call__(self, line: str = "") -> None:
        self.lines.append(line)
        if self.verbose:
            print(line, flush=True)

    @property
    def text(self) -> str:
        return "".join(f"{line}\n" for line in self.lines)
