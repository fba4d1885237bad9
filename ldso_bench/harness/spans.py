"""Host spans and kept calls, patched around the program's functions.

A span target is ``"module:attr"`` or ``"module:Class.method"``. The
program is not edited: the harness sets a wrapper on the module or class
attribute for the run and puts the original back afterwards (the stage
labels of ``chip_smoke.py``'s phase 4 are set the same way).
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch


def resolve(target: str):
    """(owner, attribute name) of ``"module:attr"`` or ``"module:Class.attr"``."""
    mod_name, path = target.split(":")
    owner = importlib.import_module(mod_name)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


def clone(x):
    """A copy of every tensor in ``x`` (tuples, lists, dicts, NamedTuples);
    numpy arrays copied, anything else kept as it is."""
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(clone(v) for v in x)
    if isinstance(x, dict):
        return {k: clone(v) for k, v in x.items()}
    return x


class Patches:
    """Wrappers set on program attributes, all put back by ``restore``."""

    def __init__(self):
        self._undo = []

    def wrap(self, target: str, make):
        owner, name = resolve(target)
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self._undo.append((owner, name, orig))

    def restore(self):
        while self._undo:
            owner, name, orig = self._undo.pop()
            setattr(owner, name, orig)


class Spans:
    """Host milliseconds of each call under a label (the outermost call of
    a label; a call nested in one of the same label is its part), and,
    while ``profiling``, a ``record_function`` of the label around it."""

    def __init__(self, patches: Patches):
        self.patches = patches
        self.ms: dict = {}
        self.profiling = False
        self._depth: dict = {}

    def add(self, label: str, target: str):
        self.ms.setdefault(label, [])
        self._depth.setdefault(label, 0)

        def make(fn):
            def timed(*args, **kw):
                if self._depth[label]:
                    return fn(*args, **kw)
                self._depth[label] += 1
                t0 = time.perf_counter()
                try:
                    if self.profiling:
                        with torch.profiler.record_function(label):
                            return fn(*args, **kw)
                    return fn(*args, **kw)
                finally:
                    self.ms[label].append(1e3 * (time.perf_counter() - t0))
                    self._depth[label] -= 1
            return timed

        self.patches.wrap(target, make)

    def reset(self):
        for v in self.ms.values():
            v.clear()


class Keep:
    """Keeps (cloned) the arguments, keywords and result of a sample of a
    function's calls: a reservoir of ``k`` drawn with ``rng`` over the
    calls made while ``on``, so every call is equally likely to be kept
    whatever their number; ``when(*args)`` may refuse a call, and
    ``attach()``, called after a kept call, adds what it returns (``inner``)."""

    def __init__(self, patches: Patches, target: str, k: int, rng: np.random.Generator,
                 when=None, attach=None):
        self.k, self.rng, self.when, self.attach = k, rng, when, attach
        self.kept: list = []
        self.seen = 0
        self.on = False

        def make(fn):
            def kept(*args, **kw):
                if not self.on or (self.when is not None and not self.when(*args)):
                    return fn(*args, **kw)
                i, self.seen = self.seen, self.seen + 1
                slot = i if i < self.k else int(self.rng.integers(0, i + 1))
                if slot >= self.k:
                    return fn(*args, **kw)
                rec = dict(call=i, args=clone(args), kw=clone(kw))
                out = fn(*args, **kw)
                rec["out"] = clone(out)
                if self.attach is not None:
                    rec["inner"] = clone(self.attach())
                if slot < len(self.kept):
                    self.kept[slot] = rec
                else:
                    self.kept.append(rec)
                return out
            return kept

        patches.wrap(target, make)


class Last:
    """The latest call of a function: its arguments and result (not
    copied: the caller reads them before the next call)."""

    def __init__(self, patches: Patches, target: str):
        self.args = self.out = None

        def make(fn):
            def recorded(*args, **kw):
                out = fn(*args, **kw)
                self.args, self.out = args, out
                return out
            return recorded

        patches.wrap(target, make)


class Record:
    """While ``on``, ``read(args, result)`` of every call of a function,
    where it returns something other than None, in ``rows``."""

    def __init__(self, patches: Patches, target: str, read):
        self.rows: list = []
        self.on = False

        def make(fn):
            def recorded(*args, **kw):
                out = fn(*args, **kw)
                if self.on:
                    row = read(args, out)
                    if row is not None:
                        self.rows.append(row)
                return out
            return recorded

        patches.wrap(target, make)
