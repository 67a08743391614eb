"""Project "deck" (input data file) parser.

Parses the reference solver's key/value + table configuration format so the
shipped TestCases run unmodified (reference: obj_data/obj_data.cpp:829-1430).

Format::

    ; comment to end of line
    <start/Name>                 ; opens the data envelope
    <data/key=value>             ; scalar directive, typed on access
    <table=name/N>               ; table header, N rows follow
    x0  y0
    ...
    <endtable>
    <end/Name>                   ; optional in practice

Access semantics mirror the reference's ``InputData``:

* values are typed lazily: ``get_int`` uses ``atoi`` semantics and
  ``get_float`` uses ``strtod`` semantics (longest valid numeric prefix, so
  ``"3338.0."`` parses as 3338.0 and ``"-0.1735.3e7"`` as -0.1735);
* a missing key sets an error flag; the reference aborts on required keys and
  silently continues (value 0) on optional ones — here ``required=True``
  raises ``DeckError`` while ``required=False`` returns ``default``.
"""

from __future__ import annotations

import io
import re
from dataclasses import dataclass, field

import numpy as np

from .tables import Table

_FLOAT_PREFIX_RE = re.compile(
    r"^\s*[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?")
_INT_PREFIX_RE = re.compile(r"^\s*[+-]?\d+")


class DeckError(RuntimeError):
    """Raised for malformed decks or missing required keys."""


def strtod(s: str) -> float:
    """C ``strtod`` semantics: parse the longest valid leading float, else 0."""
    m = _FLOAT_PREFIX_RE.match(s)
    return float(m.group(0)) if m else 0.0


def atoi(s: str) -> int:
    """C ``atoi`` semantics: parse the longest valid leading integer, else 0."""
    m = _INT_PREFIX_RE.match(s)
    return int(m.group(0)) if m else 0


def _strip_comment(line: str) -> str:
    pos = line.find(";")
    return line if pos < 0 else line[:pos]


@dataclass
class Deck:
    """Parsed deck: scalar directives + named tables (InputData equivalent)."""

    name: str = ""
    data: dict[str, str] = field(default_factory=dict)
    tables: dict[str, Table] = field(default_factory=dict)
    # mirrors InputData::GetDataError(): -1 after a failed lookup, 0 otherwise
    error: int = 0

    # -- typed accessors (obj_data.cpp:1488-1660) ---------------------------
    def _raw(self, key: str, required: bool):
        if key in self.data:
            self.error = 0
            return self.data[key]
        self.error = -1
        if required:
            raise DeckError(f"Data object {key!r} not found in deck "
                            f"{self.name!r}")
        return None

    def get_int(self, key: str, default: int = 0, required: bool = True) -> int:
        raw = self._raw(key, required)
        return atoi(raw) if raw is not None else default

    def get_float(self, key: str, default: float = 0.0,
                  required: bool = True) -> float:
        raw = self._raw(key, required)
        return strtod(raw) if raw is not None else default

    def get_str(self, key: str, default: str = "",
                required: bool = True) -> str:
        raw = self._raw(key, required)
        return raw if raw is not None else default

    def get_table(self, key: str, required: bool = True) -> Table | None:
        if key in self.tables:
            self.error = 0
            return self.tables[key]
        self.error = -1
        if required:
            raise DeckError(f"Table {key!r} not found in deck {self.name!r}")
        return None

    def has(self, key: str) -> bool:
        return key in self.data or key in self.tables


def parse_deck(source: str | io.TextIOBase, name_hint: str = "") -> Deck:
    """Parse deck text (or a file-like object) into a :class:`Deck`.

    Mirrors ``InputData::GetDataFromFile`` (obj_data.cpp:1124-1430): the
    ``<start/...>`` directive opens the envelope, ``<data/k=v>`` directives are
    collected verbatim (value runs to the closing ``>``), ``<table=name/N>``
    reads exactly N "x y" rows terminated by ``<endtable>``.
    """
    if hasattr(source, "read"):
        text = source.read()
    else:
        text = source

    deck = Deck(name=name_hint)
    started = False
    lines = text.splitlines()
    i = 0
    n = len(lines)
    while i < n:
        line = _strip_comment(lines[i])
        i += 1
        if "<start/" in line:
            if started:
                raise DeckError("<start/...> directive defined twice")
            started = True
            frag = line.split("<start/", 1)[1]
            deck.name = frag.split(">", 1)[0].strip()
            continue
        if "<data/" in line:
            if not started:
                raise DeckError("<start/...> directive not found")
            frag = line.split("<data/", 1)[1]
            if ">" not in frag or "=" not in frag.split(">", 1)[0]:
                raise DeckError(f"Error <data/...> directive: {line!r}")
            body = frag.split(">", 1)[0]
            key, val = body.split("=", 1)
            deck.data[key.strip()] = val.strip()
            continue
        if "<table=" in line:
            if not started:
                raise DeckError("<start/...> directive not found")
            frag = line.split("<table=", 1)[1]
            body = frag.split(">", 1)[0]
            if "/" not in body:
                raise DeckError(f"Error <table=.../...> directive: {line!r}")
            tname, count_s = body.split("/", 1)
            tname = tname.strip()
            nrows = atoi(count_s)
            xs, ys = [], []
            while i < n:
                row = _strip_comment(lines[i])
                i += 1
                if "<endtable>" in row:
                    break
                row = row.strip()
                if not row:
                    continue
                parts = row.split()
                if len(parts) < 2:
                    raise DeckError(
                        f"Error <table={tname}/...> row: {row!r}")
                xs.append(strtod(parts[0]))
                ys.append(strtod(parts[1]))
            else:
                raise DeckError(f"<endtable> not found for table {tname!r}")
            if nrows and len(xs) != nrows:
                # The reference trusts the declared count; accept mismatch but
                # keep actual rows (it reads exactly the rows present).
                pass
            deck.tables[tname] = Table(np.asarray(xs, dtype=np.float64),
                                       np.asarray(ys, dtype=np.float64),
                                       name=tname)
            continue
        if started and deck.name and f"<end/{deck.name}>" in line:
            break
    if not started:
        raise DeckError("<start/...> directive not found")
    return deck


def load_deck(path: str) -> Deck:
    """Load and parse a deck file (tolerating legacy 8-bit encodings)."""
    with open(path, "rb") as f:
        raw = f.read()
    text = raw.decode("utf-8", errors="replace")
    return parse_deck(text, name_hint=path)


def deck_to_text(deck: Deck) -> str:
    """Serialize a Deck back to the reference's file format (the inverse
    of parse_deck, round-trip tested): used to write programmatically
    built example decks to disk for CLI-level runs."""
    lines = [f"<start/{deck.name or 'deck'}>"]
    for k, v in deck.data.items():
        lines.append(f"<data/{k}={v}>")
    for name, tab in deck.tables.items():
        n = len(tab.x)
        lines.append(f"<table={name}/{n}>")
        for xv, yv in zip(tab.x, tab.y):
            lines.append(f"{float(xv)!r} {float(yv)!r}")
        lines.append("<endtable>")
    lines.append(f"<end/{deck.name or 'deck'}>")
    return "\n".join(lines) + "\n"
