"""The one generator of the benchmark's inputs.  A traffic mix is a data
file of parameters (``perfbench/traffic/<mix>.json``); its ``kind`` names
the code that makes the inputs from them and the seed,
``perfbench/traffic/<kind>.py`` (``make(mix, seed, device)``), found by
name:

* ``multiview_object``: Blender-shaped views of an analytic object
  (``harness/scene.py``), held on the host as ``MultiviewData`` holds a
  loaded scene;
* ``photo``: one 8-bit kodak-like photo.

A new mix of a kind is a data file alone; a new kind is a file of its
own beside the mixes.
"""
from __future__ import annotations

from perfbench.harness import bench


def make(root: str, mix: dict, seed: int, device):
    """The inputs of a traffic mix for ``seed``."""
    return bench.kind(root, mix['kind']).make(mix, seed, device)
