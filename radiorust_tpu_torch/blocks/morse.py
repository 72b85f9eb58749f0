"""Morse code: speed conversions, text encoding and the keyer source
(port of the JAX package's ``blocks/morse.py``; host-side numpy).

- :class:`Speed`: PARIS/CODEX wpm/cpm conversions.
- :class:`Unit`: dit/dah/space elements with relative durations.
- :func:`encode`: the ITU table plus ``<prosign>`` syntax.
- :class:`Keyer`: on/off-keyed unit-amplitude IQ chunks.  Units expand on
  the host into a keying envelope; the envelope is data-independent
  control logic, so there is no per-sample device work.

Events :class:`StartOfMessages` / :class:`EndOfMessages` frame a burst of
queued messages.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..math import round_half_away
from ..numbers import COMPLEX_DTYPE
from ..signal import Event

__all__ = [
    "Speed", "Unit", "EncodeError", "encode", "units_to_envelope", "Keyer",
    "StartOfMessages", "EndOfMessages",
]


class StartOfMessages(Event):
    """Event: the keyer is about to send queued messages."""


class EndOfMessages(Event):
    """Event: the keyer finished all queued messages."""


@dataclass(frozen=True)
class Speed:
    """Morse speed in dits per minute."""

    dits_per_minute_: float

    @classmethod
    def from_paris_cpm(cls, cpm: float) -> "Speed":
        return cls(10.0 * cpm)

    @classmethod
    def from_codex_cpm(cls, cpm: float) -> "Speed":
        return cls(12.0 * cpm)

    @classmethod
    def from_paris_wpm(cls, wpm: float) -> "Speed":
        return cls.from_paris_cpm(5.0 * wpm)

    @classmethod
    def from_codex_wpm(cls, wpm: float) -> "Speed":
        return cls.from_codex_cpm(5.0 * wpm)

    @classmethod
    def from_dits_per_minute(cls, dpm: float) -> "Speed":
        return cls(dpm)

    def paris_cpm(self) -> float:
        return self.dits_per_minute_ / 10.0

    def codex_cpm(self) -> float:
        return self.dits_per_minute_ / 12.0

    def paris_wpm(self) -> float:
        return self.paris_cpm() / 5.0

    def codex_wpm(self) -> float:
        return self.codex_cpm() / 5.0

    def dits_per_minute(self) -> float:
        return self.dits_per_minute_

    def seconds_per_dit(self) -> float:
        return 60.0 / self.dits_per_minute_

    def samples_per_dit(self, sample_rate: float) -> float:
        return 60.0 * sample_rate / self.dits_per_minute_


class Unit(enum.Enum):
    """Morse elements."""

    DIT = "dit"
    DAH = "dah"
    SPACE = "space"
    CHAR_SPACE = "char_space"
    WORD_SPACE = "word_space"
    PADDING = "padding"

    @property
    def on(self) -> bool:
        return self in (Unit.DIT, Unit.DAH)

    @property
    def relative_duration(self) -> float:
        return {
            Unit.DIT: 1.0,
            Unit.DAH: 3.0,
            Unit.SPACE: 1.0,
            Unit.CHAR_SPACE: 3.0,
            Unit.WORD_SPACE: 7.0,
            Unit.PADDING: 3.5,
        }[self]

    def samples(self, sample_rate: float, speed: Speed) -> float:
        return speed.samples_per_dit(sample_rate) * self.relative_duration


class EncodeError(ValueError):
    """Text cannot be converted to morse code."""


def _pattern(code: str) -> List[Unit]:
    """Expand a dotdash string like '.-' into units with intra-char spaces."""
    out: List[Unit] = []
    for i, c in enumerate(code):
        if i:
            out.append(Unit.SPACE)
        out.append(Unit.DIT if c == "." else Unit.DAH)
    return out


# The ITU table as dotdash strings.
_MORSE_TABLE = {
    "0": "-----", "1": ".----", "2": "..---", "3": "...--", "4": "....-",
    "5": ".....", "6": "-....", "7": "--...", "8": "---..", "9": "----.",
    "A": ".-", "B": "-...", "C": "-.-.", "D": "-..", "E": ".", "F": "..-.",
    "G": "--.", "H": "....", "I": "..", "J": ".---", "K": "-.-", "L": ".-..",
    "M": "--", "N": "-.", "O": "---", "P": ".--.", "Q": "--.-", "R": ".-.",
    "S": "...", "T": "-", "U": "..-", "V": "...-", "W": ".--", "X": "-..-",
    "Y": "-.--", "Z": "--..",
    "/": "-..-.", "+": ".-.-.", "=": "-...-", "-": "-....-", ".": ".-.-.-",
    ",": "--..--", "?": "..--..", "(": "-.--.", ")": "-.--.-", '"': ".-..-.",
    ":": "---...", ";": "-.-.-.", "&": ".-...", "'": ".----.", "!": "-.-.--",
    "_": "..--.-", "$": "...-..-", "@": ".--.-.",
}


def encode(text: str) -> List[Unit]:
    """Encode text as a unit sequence.

    Supports ``<prosign>`` syntax (letters run together without char
    spacing); raises :class:`EncodeError` on invalid input.
    """
    out: List[Unit] = [Unit.PADDING]
    prosign = False
    previous_char = False
    for c in text.upper():
        if c == "<":
            if prosign:
                raise EncodeError("double opening bracket")
            if previous_char:
                previous_char = False
                out.append(Unit.CHAR_SPACE)
            prosign = True
        elif c == ">":
            if not prosign or not previous_char:
                raise EncodeError("unexpected closing bracket")
            prosign = False
        elif c == " ":
            if prosign:
                raise EncodeError("space in prosign")
            previous_char = False
            out.append(Unit.WORD_SPACE)
        else:
            code = _MORSE_TABLE.get(c)
            if code is None:
                if not c.isascii():
                    raise EncodeError("unsupported non-ASCII character")
                if ord(c) < 0x20 or ord(c) == 0x7F:
                    raise EncodeError("unsupported ASCII control character")
                raise EncodeError(f'unsupported character "{c}"')
            if previous_char:
                out.append(Unit.SPACE if prosign else Unit.CHAR_SPACE)
            previous_char = True
            out.extend(_pattern(code))
    out.append(Unit.PADDING)
    return out


def units_to_envelope(units: Sequence[Unit], sample_rate: float,
                      speed: Speed) -> np.ndarray:
    """Expand units into a float32 on/off envelope.

    Each unit lasts ``round(unit.samples(rate, speed))`` samples, rounded
    half away from zero (``round_half_away``): Python's ``round`` would
    drop one sample on every exact .5 tie (e.g. samples_per_dit = 312.5).
    """
    parts = []
    for unit in units:
        n = round_half_away(unit.samples(sample_rate, speed))
        parts.append(np.full(n, 1.0 if unit.on else 0.0, dtype=np.float32))
    if not parts:
        return np.zeros(0, dtype=np.float32)
    return np.concatenate(parts)


class Keyer:
    """Morse keyer source.

    Queue messages with :meth:`send`; :meth:`chunks` yields
    ``(chunk, events)`` pairs where ``chunk`` is a ``[chunk_len]`` complex64
    on/off envelope and ``events`` lists the events that precede the
    chunk.  With the queue empty it yields silence, with one
    :class:`EndOfMessages` event after the queue drains.
    """

    def __init__(self, chunk_len: int, sample_rate: float, speed: Speed,
                 message: Optional[str] = None):
        self.chunk_len = int(chunk_len)
        self.sample_rate = float(sample_rate)
        self.speed = speed
        self._queue: List[List[Unit]] = []
        self._pending = np.zeros(0, dtype=np.float32)
        self._idle = True
        if message is not None:
            self.send(message)

    def send(self, text: str) -> None:
        self._queue.append(encode(text))

    def set_speed(self, speed: Speed) -> None:
        self.speed = speed

    def _refill(self) -> List[object]:
        events: List[object] = []
        if self._queue:
            if self._idle:
                events.append(StartOfMessages())
                self._idle = False
            while self._queue:
                units = self._queue.pop(0)
                env = units_to_envelope(units, self.sample_rate, self.speed)
                self._pending = np.concatenate([self._pending, env])
        return events

    def chunks(self, count: int) -> Iterator[tuple]:
        """Yield ``count`` (chunk, events) pairs."""
        for _ in range(count):
            events = self._refill()
            if len(self._pending) >= self.chunk_len:
                out = self._pending[: self.chunk_len]
                self._pending = self._pending[self.chunk_len:]
            else:
                out = np.zeros(self.chunk_len, dtype=np.float32)
                out[: len(self._pending)] = self._pending
                self._pending = np.zeros(0, dtype=np.float32)
                if not self._idle:
                    events.append(EndOfMessages())
                    self._idle = True
            yield out.astype(COMPLEX_DTYPE), events

    def envelope(self, total_chunks: int) -> np.ndarray:
        """Render ``total_chunks`` chunks as a [T, chunk_len] complex64 batch
        (events dropped): the bulk entry point for compiled-graph runs."""
        return np.stack([c for c, _ in self.chunks(total_chunks)])
