"""Milliseconds of the card's own time per thousand output tokens emitted
in the window: every kernel, fill and copy of the window's rounds, less
the copies from or to pageable host memory, whose span on the card is the
host's staging (``portbench.trace.CardTime``)."""


def read(run):
    card = run.card
    n = run.emitted()
    if card is None or card.card_s <= 0 or n <= 0:
        return None
    return 1e6 * card.card_s / n
