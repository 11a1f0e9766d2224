"""Warm apply launches whose flat-copy rows were also widened to copy
the blocks around their end pieces (the kernel's ``span``,
``sweep._row_pad``; counter ``apply_rows.span``) over warm apply launches
on the card, in % (``bench/apply_rows.py``)."""

from bench.apply_rows import share


def read(rec):
    return share("span")
