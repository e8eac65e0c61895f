"""Percent of the encoder frames the program computed over the window
that were padding: ``100 · (1 − valid / computed)``, the valid frames the
window's requests hold (the cell's ``frames``) over what the program's
``W2V2_FRAMES`` counter moved (``drivers/asr_serve.py``).  None where
the program has no such counter."""


def read(m):
    w = m["window"]
    computed = w.get("w2v2_frames")
    if not computed:
        return None
    return 100.0 * (1.0 - w["frames"] / computed)
