"""Warm apply launches whose bf16 kernel computed two neighbouring outputs
along c1 a thread (the kernel's pair loop; counter ``apply_rows.pair``)
over warm apply launches on the card, in % (``bench/apply_rows.py``).  A
port without the counter reads ``None``."""

from bench.apply_rows import share


def read(rec):
    return share("pair")
