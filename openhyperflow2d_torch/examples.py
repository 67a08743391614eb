"""Programmatic example decks.

The deck functions are host-side text generators with no jax in them; the
port uses the JAX package's module as it is and re-exports it here, so
callers of the port import decks from the port.
"""

from openhyperflow2d_tpu.examples import (airfoil_deck, bubble_deck,
                                          channel_deck, combustor_deck,
                                          cylinders_deck, freestream_deck,
                                          reacting_rans_deck, scramjet_deck)

__all__ = ["airfoil_deck", "bubble_deck", "channel_deck", "combustor_deck",
           "cylinders_deck", "freestream_deck", "reacting_rans_deck",
           "scramjet_deck"]
