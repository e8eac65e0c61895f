"""Percent of a streaming step's device time that its decode stage (the
greedy frames and symbols, ``rnnt.replay.decode`` where replayed) took:
CUDA events recorded as each stage begins and after the last, summed over
the window (``drivers/stream_serve.py``).  None where the program has no
stages to mark, and off the card."""


def read(m):
    return m["window"].get("rnnt_decode_share")
