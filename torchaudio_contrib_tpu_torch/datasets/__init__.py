"""Dataset parsers of the port (local files only).

Port of ``torchaudio_contrib_tpu/datasets``, so far only :class:`CMUDict`,
which the phone text processor of the TTS bundles reads (the JAX package's
``datasets/__init__`` imports its ``io``, which imports JAX).  Nothing is
downloaded: a class indexes a directory that holds the files and raises
when it is missing.
"""
from __future__ import annotations

import os
from typing import List, Tuple

__all__ = ["CMUDict"]


def _require_dir(path: str, hint: str) -> None:
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path} does not exist. Datasets are never downloaded; "
            f"place the extracted corpus there ({hint}).")


class CMUDict:
    """CMU Pronouncing Dictionary: ``root/cmudict-0.7b`` (latin-1
    text, ``;;;`` comments, entries ``WORD  PH1 PH2 ...``) plus the
    optional ``cmudict-0.7b.symbols`` phone list.

    ``__getitem__`` → ``(word, [phonemes])`` (torchaudio's tuple).
    Alternate pronunciations (``WORD(1)``) keep the word with the
    marker stripped, as separate items.  ``exclude_punctuations``
    (default True) drops entries whose head is a punctuation token
    (e.g. ``!EXCLAMATION-POINT``)."""

    def __init__(self, root: str, exclude_punctuations: bool = True,
                 dict_file: str = "cmudict-0.7b",
                 symbols_file: str = "cmudict-0.7b.symbols"):
        _require_dir(root, "cmudict-0.7b [+ .symbols]")
        path = os.path.join(root, dict_file)
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"{path} does not exist. Datasets are never downloaded; "
                "place the dictionary file there.")
        self._entries: List[Tuple[str, List[str]]] = []
        with open(path, encoding="latin-1") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith(";;;"):
                    continue
                word, _, phones = line.partition("  ")
                if not phones:
                    word, _, phones = line.partition(" ")
                # punctuation entries name a punctuation mark
                # (!EXCLAMATION-POINT, "CLOSE-QUOTE, 'END-QUOTE, …);
                # apostrophe-initial WORDS ('BOUT, 'CAUSE, 'TIS) are
                # real vocabulary and must survive the filter — the
                # dictionary's apostrophe punctuation entries all
                # name QUOTE
                is_punct = (not word[:1].isalnum()
                            and (word[:1] != "'" or "QUOTE" in word))
                if exclude_punctuations and is_punct:
                    continue
                if word.endswith(")") and "(" in word:
                    word = word[:word.rfind("(")]
                self._entries.append((word, phones.split()))
        self._symbols: List[str] = []
        spath = os.path.join(root, symbols_file)
        if os.path.isfile(spath):
            with open(spath, encoding="latin-1") as f:
                self._symbols = [ln.strip() for ln in f if ln.strip()]

    @property
    def symbols(self) -> List[str]:
        """Phone symbols from the ``.symbols`` file (may be empty if
        the file is absent)."""
        return list(self._symbols)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, n: int):
        word, phones = self._entries[n]
        return word, list(phones)
