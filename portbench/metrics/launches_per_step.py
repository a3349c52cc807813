"""Launches of the port's kernel wrappers a step over the traced chunks
(``ops.substage``'s ``substage.launches`` and ``multistep.launches``,
counted through graph replays)."""

from __future__ import annotations


def read(ctx):
    n = sum(ctx.launches.values())
    return n / ctx.steps if n and ctx.steps else None
