"""Warm apply launches whose window rows all took the flat 16-byte copy
(the kernel's ``copy16``; counter ``apply_rows.copy16``) over warm apply
launches on the card, in % (``bench/apply_rows.py``)."""

from bench.apply_rows import share


def read(rec):
    return share("copy16")
