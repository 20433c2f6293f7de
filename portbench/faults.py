"""Faults planted in the system under test, for the check that a broken
timed path comes out not correct.  Each kind of traffic lists its own in
``kinds/<kind>.py`` (``FAULTS``): a state left unchanged (``stale``),
half of the batch left out (``half``), an answer altered where it is
produced (``altered``); one card, so no exchange between chips to leave
out.  A fault replaces one function of the program through
``patch(owner, name, value)`` (``setattr``, or pytest's
``monkeypatch.setattr``).  The tests plant them at the tiny size;
``control.py --fault <kind>-<name>`` at a cell's own size on the card.
"""

from .drivers import kind, kind_names


def all_faults():
    """{"<kind>-<name>": plant} over every kind."""
    return {f"{k}-{name}": plant for k in kind_names()
            for name, plant in kind(k).FAULTS.items()}
