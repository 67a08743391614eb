"""Faults planted under the timed path, to show that the comparison finds
them: each is ``fault(setattr)``, where ``setattr(owner, name, value)``
replaces an attribute of the port (pytest's ``monkeypatch.setattr``, or
``Patch`` below).

- ``unchanged``: a chunk returns its input state (its diagnostics kept);
- ``half_left_out``: a chunk's S keeps its input on the first half of the
  grid's columns;
- ``node_altered``: one node's density scaled by 1.5 where each
  iteration's pass12 launches write it."""

from __future__ import annotations


def _chunk_class():
    from openhyperflow2d_torch.ops import fused_step
    return fused_step


def unchanged(setattr):
    fs = _chunk_class()
    call = fs.KernelChunk.__call__

    def chunk(self, state, n, it, src=None):
        _, diags = call(self, state, n, it, src)
        return state, diags
    setattr(fs.KernelChunk, "__call__", chunk)


def half_left_out(setattr):
    fs = _chunk_class()
    call = fs.KernelChunk.__call__

    def chunk(self, state, n, it, src=None):
        out, diags = call(self, state, n, it, src)
        X = out.S.shape[1]
        S = out.S.clone()
        S[:, : X // 2] = state.S[:, : X // 2]
        return out.replace(S=S), diags
    setattr(fs.KernelChunk, "__call__", chunk)


def node_altered(setattr):
    fs = _chunk_class()
    call = fs.FusedStep.path_pass12

    def path_pass12(self, cin, cout, *a, **kw):
        r = call(self, cin, cout, *a, **kw)
        X, Y = cout.shape[1:]
        cout[0, X // 2, Y // 2] *= 1.5
        return r
    setattr(fs.FusedStep, "path_pass12", path_pass12)


FAULTS = {"unchanged": unchanged, "half": half_left_out,
          "node": node_altered}


class Patch:
    """``setattr`` that remembers each original; ``undo`` restores them."""

    def __init__(self):
        self.saved = []

    def __call__(self, owner, name, value):
        self.saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, value)

    def undo(self):
        while self.saved:
            owner, name, value = self.saved.pop()
            setattr(owner, name, value)
