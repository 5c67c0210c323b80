"""Scenes trained a second: the scenes of every optimizer step completed
in the window (source and target scenes in self-training), its loss read
back on the host, over the window's seconds (host clock)."""

from portbench.metrics._common import rate


def read(rec):
    return rate(rec) if rec['kind'] in ('train', 'st') else None
