"""Process start to the window's opening: imports, the card, kernel
libraries (built in the first run of a checkout), inputs, plans, warm-up."""


def read(rec):
    return rec["setup_s"]
