"""The frozen deck parses to what its generator gives at 2048²."""

import pytest

from openhyperflow2d_torch.config.deck import load_deck
from openhyperflow2d_torch.examples import combustor_deck
from portbench.reference.config.deck import load_deck as ref_load_deck
from portbench.registry import ROOT

DECKS = {"combustor_keps_2048": lambda: combustor_deck(2048, 2048, cfl=0.05)}


@pytest.mark.parametrize("name", sorted(DECKS))
@pytest.mark.parametrize("parse", [load_deck, ref_load_deck],
                         ids=["port", "reference"])
def test_frozen_deck_is_its_generator(name, parse):
    want = DECKS[name]()
    got = parse(str(ROOT / "configs" / name / "deck.dat"))
    assert got.data == want.data
    assert list(got.tables) == list(want.tables)
    for k, t in want.tables.items():
        assert list(got.tables[k].x) == list(t.x)
        assert list(got.tables[k].y) == list(t.y)
