"""Dataset layout parsers + batching utilities (local files only).

The port of the JAX package's ``datasets``: torchaudio's ``datasets``
capability for the common corpora as *local-directory* parsers.  Unlike
torchaudio these classes never download — they index an existing
directory tree laid out the standard way and raise with a clear message
when it is missing.

Audio decoding rides the port's native WAV + FLAC codecs (:mod:`..io`,
content-sniffing dispatch) — LibriSpeech-family corpora work directly on
their released FLAC trees (``ext=".flac"``); the ``ext`` argument also
indexes externally-converted WAV trees identically.

Items carry CPU float32 tensors (``(channels, frames)``, as the codec
decodes them): decoding is host work, and ``DataLoader`` workers cannot
touch CUDA, so the caller moves a batch to the card.  ``num_frames`` reads
the header only.

Batching: ``pad_collate`` produces padded tensors + lengths,
``bucket_indices`` groups similar-length clips to cut padding, and
``batch_iterator`` is a deterministic, seedable host-side loader.  A
shuffle takes an int seed (the JAX package's permutation:
``np.random.default_rng(seed)``) or a ``torch.Generator``.
"""
from __future__ import annotations

import os
import csv
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io import read_audio, audio_info

__all__ = [
    "AudioFolder", "LIBRISPEECH", "LJSPEECH", "SPEECHCOMMANDS",
    "YESNO", "CMUARCTIC", "LIBRITTS", "VCTK_092", "GTZAN",
    "COMMONVOICE", "MUSDB_HQ", "TEDLIUM", "FLUENTSPEECHCOMMANDS",
    "FluentSpeechCommands",
    "CMUDict", "LibriLightLimited", "LibriMix", "DR_VCTK",
    "IEMOCAP", "QUESST14", "Snips",
    "VoxCeleb1Identification", "VoxCeleb1Verification",
    "pad_collate", "bucket_indices", "batch_iterator",
]


def _require_dir(path: str, hint: str) -> None:
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path} does not exist. Datasets are never downloaded; "
            f"place the extracted corpus there ({hint}).")


def _tensor(wav) -> torch.Tensor:
    """A decoded ``(channels, frames)`` array as a CPU float32 tensor."""
    return torch.from_numpy(np.asarray(wav, np.float32))


def _header_frames(path: str) -> int:
    """``num_frames`` from the WAV/FLAC header alone — reads at most 64 KiB
    (falling back to the whole file for exotic chunk layouts) so
    length-bucketing never decodes the corpus up front."""
    with open(path, "rb") as f:
        head = f.read(65536)
    try:
        return int(audio_info(head)["num_frames"])
    except ValueError:
        return int(audio_info(path)["num_frames"])


class AudioFolder:
    """Generic recursive folder dataset: every ``ext`` file under
    ``root``.  ``__getitem__`` → ``(waveform (C, T) float32 tensor,
    sample_rate, relpath)``."""

    def __init__(self, root: str, ext: str = ".wav"):
        _require_dir(root, f"any tree of {ext} files")
        self.root = root
        self._files: List[str] = []
        for dirpath, _, names in sorted(os.walk(root)):
            for n in sorted(names):
                if n.endswith(ext):
                    self._files.append(os.path.join(dirpath, n))
        self.ext = ext

    def __len__(self):
        return len(self._files)

    def path(self, n: int) -> str:
        return self._files[n]

    def num_frames(self, n: int) -> int:
        """Item length in samples from the header (no decode)."""
        return _header_frames(self.path(n))

    def _load(self, path):
        data, sr = read_audio(path)
        return _tensor(data), sr

    def __getitem__(self, n: int):
        path = self._files[n]
        wav, sr = self._load(path)
        return wav, sr, os.path.relpath(path, self.root)


class LIBRISPEECH(AudioFolder):
    """LibriSpeech layout:
    ``root/LibriSpeech/<url>/<speaker>/<chapter>/<spk>-<chap>-<utt>{ext}``
    with per-chapter ``<spk>-<chap>.trans.txt`` transcript files.

    ``__getitem__`` → ``(waveform, sample_rate, transcript,
    speaker_id, chapter_id, utterance_id)`` (torchaudio's tuple).
    ``ext=None`` (default) auto-detects: the released ``.flac`` tree
    if any FLAC files are present (decoded natively since round 4),
    else a converted ``.wav`` tree."""

    def __init__(self, root: str, url: str = "train-clean-100",
                 folder_in_archive: str = "LibriSpeech",
                 ext: Optional[str] = None):
        base = os.path.join(root, folder_in_archive, url)
        if ext is None:
            ext = ".wav"
            for dirpath, _, names in os.walk(base):
                if any(n.endswith(".flac") for n in names):
                    ext = ".flac"
                    break
        _require_dir(base, "LibriSpeech/<subset>/<spk>/<chap>/*" + ext)
        super().__init__(base, ext)
        self._trans = {}
        for dirpath, _, names in os.walk(base):
            for n in names:
                if n.endswith(".trans.txt"):
                    with open(os.path.join(dirpath, n)) as f:
                        for line in f:
                            key, _, text = line.strip().partition(" ")
                            self._trans[key] = text

    def __getitem__(self, n: int):
        path = self._files[n]
        wav, sr = self._load(path)
        utt = os.path.splitext(os.path.basename(path))[0]
        spk, chap, uid = utt.split("-")
        text = self._trans.get(utt)
        if text is None:
            raise KeyError(f"no transcript for {utt}")
        return wav, sr, text, int(spk), int(chap), int(uid)


class LJSPEECH:
    """LJSpeech layout: ``root/LJSpeech-1.1/wavs/*.wav`` +
    ``metadata.csv`` (``id|transcript|normalized``).

    ``__getitem__`` → ``(waveform, sample_rate, transcript,
    normalized_transcript)``."""

    def __init__(self, root: str,
                 folder_in_archive: str = "LJSpeech-1.1"):
        base = os.path.join(root, folder_in_archive)
        _require_dir(base, "LJSpeech-1.1/{wavs,metadata.csv}")
        self._wavs = os.path.join(base, "wavs")
        meta = os.path.join(base, "metadata.csv")
        self._rows: List[Tuple[str, str, str]] = []
        with open(meta, newline="", encoding="utf-8") as f:
            for row in csv.reader(f, delimiter="|",
                                  quoting=csv.QUOTE_NONE):
                self._rows.append((row[0], row[1], row[2]))

    def __len__(self):
        return len(self._rows)

    def path(self, n: int) -> str:
        return os.path.join(self._wavs, self._rows[n][0] + ".wav")

    def num_frames(self, n: int) -> int:
        return _header_frames(self.path(n))

    def __getitem__(self, n: int):
        fid, text, norm = self._rows[n]
        wav, sr = read_audio(self.path(n))
        return _tensor(wav), sr, text, norm


class SPEECHCOMMANDS(AudioFolder):
    """Speech Commands layout: ``root/SpeechCommands/speech_commands_v0.02/
    <label>/<speaker>_nohash_<n>.wav``.

    ``__getitem__`` → ``(waveform, sample_rate, label, speaker_id,
    utterance_number)``."""

    def __init__(self, root: str,
                 folder_in_archive: str = "SpeechCommands",
                 url: str = "speech_commands_v0.02"):
        base = os.path.join(root, folder_in_archive, url)
        _require_dir(base, "SpeechCommands/<ver>/<label>/*.wav")
        super().__init__(base, ".wav")
        self._files = [p for p in self._files
                       if "_background_noise_" not in p]

    def __getitem__(self, n: int):
        path = self._files[n]
        wav, sr = self._load(path)
        label = os.path.basename(os.path.dirname(path))
        name = os.path.splitext(os.path.basename(path))[0]
        spk, _, num = name.partition("_nohash_")
        return wav, sr, label, spk, int(num or 0)


class YESNO(AudioFolder):
    """YesNo layout: ``root/waves_yesno/<0_1_...>.wav`` — eight
    binary digits in the filename are the labels.

    ``__getitem__`` → ``(waveform, sample_rate, labels list[int])``."""

    def __init__(self, root: str,
                 folder_in_archive: str = "waves_yesno"):
        base = os.path.join(root, folder_in_archive)
        _require_dir(base, "waves_yesno/*.wav")
        super().__init__(base, ".wav")

    def __getitem__(self, n: int):
        path = self._files[n]
        wav, sr = self._load(path)
        name = os.path.splitext(os.path.basename(path))[0]
        labels = [int(c) for c in name.split("_")]
        return wav, sr, labels


class CMUARCTIC(AudioFolder):
    """CMU ARCTIC layout: ``root/ARCTIC/cmu_us_<spk>_arctic/wav/
    arctic_?0000.wav`` + ``etc/txt.done.data`` lines of the form
    ``( arctic_a0001 "Text." )``.

    ``__getitem__`` → ``(waveform, sample_rate, transcript,
    utterance_id)`` (torchaudio's tuple)."""

    def __init__(self, root: str, url: str = "cmu_us_aew_arctic",
                 folder_in_archive: str = "ARCTIC"):
        base = os.path.join(root, folder_in_archive, url)
        _require_dir(base, "ARCTIC/cmu_us_<spk>_arctic/{wav,etc}")
        super().__init__(os.path.join(base, "wav"), ".wav")
        self._trans = {}
        with open(os.path.join(base, "etc", "txt.done.data"),
                  encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line.startswith("("):
                    continue
                body = line[1:line.rfind(")")].strip()
                utt, _, text = body.partition(" ")
                self._trans[utt] = text.strip().strip('"')

    def __getitem__(self, n: int):
        path = self._files[n]
        wav, sr = self._load(path)
        utt = os.path.splitext(os.path.basename(path))[0]
        text = self._trans.get(utt)
        if text is None:
            raise KeyError(f"no transcript for {utt}")
        return wav, sr, text, utt


class LIBRITTS(AudioFolder):
    """LibriTTS layout: ``root/LibriTTS/<url>/<spk>/<chap>/
    <spk>_<chap>_<seg>_<utt>.wav`` with sibling ``.original.txt`` and
    ``.normalized.txt`` transcript files per utterance.

    ``__getitem__`` → ``(waveform, sample_rate, original_text,
    normalized_text, speaker_id, chapter_id, utterance_id)``."""

    def __init__(self, root: str, url: str = "train-clean-100",
                 folder_in_archive: str = "LibriTTS",
                 ext: str = ".wav"):
        base = os.path.join(root, folder_in_archive, url)
        _require_dir(base, "LibriTTS/<subset>/<spk>/<chap>/*" + ext)
        super().__init__(base, ext)

    @staticmethod
    def _read_text(path):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"missing transcript {path}")
        with open(path, encoding="utf-8") as f:
            return f.read().strip()

    def __getitem__(self, n: int):
        path = self._files[n]
        wav, sr = self._load(path)
        stem = os.path.splitext(path)[0]
        utt = os.path.basename(stem)
        spk, chap = utt.split("_")[:2]
        return (wav, sr, self._read_text(stem + ".original.txt"),
                self._read_text(stem + ".normalized.txt"),
                int(spk), int(chap), utt)


class VCTK_092:
    """VCTK 0.92 layout: ``root/VCTK-Corpus-0.92/wav48_silence_trimmed/
    <spk>/<spk>_<utt>_<mic>{ext}`` + ``txt/<spk>/<spk>_<utt>.txt``.

    ``__getitem__`` → ``(waveform, sample_rate, transcript,
    speaker_id, utterance_id)``.  The release ships FLAC; point
    ``ext`` at a converted tree (module docstring)."""

    def __init__(self, root: str, mic_id: str = "mic2",
                 folder_in_archive: str = "VCTK-Corpus-0.92",
                 ext: str = ".wav"):
        if mic_id not in ("mic1", "mic2"):
            raise ValueError("mic_id must be 'mic1' or 'mic2'")
        base = os.path.join(root, folder_in_archive)
        _require_dir(base, "VCTK-Corpus-0.92/{wav48_silence_trimmed,txt}")
        self._audio = os.path.join(base, "wav48_silence_trimmed")
        self._txt = os.path.join(base, "txt")
        self.mic_id = mic_id
        suffix = f"_{mic_id}{ext}"
        self._items: List[Tuple[str, str]] = []   # (speaker, utt)
        for spk in sorted(os.listdir(self._audio)):
            d = os.path.join(self._audio, spk)
            if not os.path.isdir(d):
                continue
            for nme in sorted(os.listdir(d)):
                if not nme.endswith(suffix):
                    continue
                utt = nme[:-len(suffix)].split("_", 1)[1]
                # torchaudio keeps only utterances with a transcript
                if os.path.isfile(os.path.join(
                        self._txt, spk, f"{spk}_{utt}.txt")):
                    self._items.append((spk, utt))
        self._suffix = suffix

    def __len__(self):
        return len(self._items)

    def path(self, n: int) -> str:
        spk, utt = self._items[n]
        return os.path.join(self._audio, spk,
                            f"{spk}_{utt}{self._suffix}")

    def num_frames(self, n: int) -> int:
        return _header_frames(self.path(n))

    def __getitem__(self, n: int):
        spk, utt = self._items[n]
        wav, sr = read_audio(self.path(n))
        with open(os.path.join(self._txt, spk,
                               f"{spk}_{utt}.txt"),
                  encoding="utf-8") as f:
            text = f.read().strip()
        return _tensor(wav), sr, text, spk, utt


class GTZAN(AudioFolder):
    """GTZAN layout: ``root/genres/<genre>/<genre>.000NN.wav``.

    ``__getitem__`` → ``(waveform, sample_rate, genre_label)``."""

    def __init__(self, root: str, folder_in_archive: str = "genres",
                 ext: str = ".wav"):
        base = os.path.join(root, folder_in_archive)
        _require_dir(base, "genres/<genre>/*.wav")
        super().__init__(base, ext)

    def __getitem__(self, n: int):
        path = self._files[n]
        wav, sr = self._load(path)
        return wav, sr, os.path.basename(os.path.dirname(path))


class COMMONVOICE:
    """Common Voice layout: ``root/{clips/,<tsv>}`` where the TSV has
    a header row and a ``path`` column naming the clip file.

    ``__getitem__`` → ``(waveform, sample_rate, metadata dict)``
    (torchaudio's tuple).  Clips ship as MP3; ``ext`` remaps entries
    onto a converted tree (e.g. ``.wav``)."""

    def __init__(self, root: str, tsv: str = "train.tsv",
                 ext: Optional[str] = ".wav"):
        _require_dir(root, "<lang>/{clips,*.tsv}")
        meta = os.path.join(root, tsv)
        if not os.path.isfile(meta):
            raise FileNotFoundError(
                f"{meta} does not exist. Datasets are never "
                "downloaded; place the corpus TSVs there.")
        self._clips = os.path.join(root, "clips")
        self.ext = ext
        with open(meta, newline="", encoding="utf-8") as f:
            reader = csv.DictReader(f, delimiter="\t",
                                    quoting=csv.QUOTE_NONE)
            self._rows = list(reader)

    def __len__(self):
        return len(self._rows)

    def path(self, n: int) -> str:
        name = self._rows[n]["path"]
        if self.ext is not None:
            name = os.path.splitext(name)[0] + self.ext
        return os.path.join(self._clips, name)

    def num_frames(self, n: int) -> int:
        return _header_frames(self.path(n))

    def __getitem__(self, n: int):
        wav, sr = read_audio(self.path(n))
        return _tensor(wav), sr, dict(self._rows[n])


class MUSDB_HQ:
    """MUSDB18-HQ layout: ``root/<subset>/<track>/<source>.wav`` with
    sources bass/drums/other/vocals (+ mixture).

    ``__getitem__`` → ``(waveforms (num_sources, channels, time),
    sample_rate, num_frames, track_name)`` (torchaudio's tuple,
    sources stacked in the order given)."""

    _ALL = ("bass", "drums", "other", "vocals")

    def __init__(self, root: str, subset: str = "train",
                 sources: Optional[Sequence[str]] = None):
        if subset not in ("train", "test"):
            raise ValueError("subset must be 'train' or 'test'")
        base = os.path.join(root, subset)
        _require_dir(base, "musdb18hq/{train,test}/<track>/*.wav")
        self.sources = tuple(sources) if sources is not None \
            else self._ALL
        self._tracks = [t for t in sorted(os.listdir(base))
                        if os.path.isdir(os.path.join(base, t))]
        self._base = base

    def __len__(self):
        return len(self._tracks)

    def path(self, n: int) -> str:
        return os.path.join(self._base, self._tracks[n])

    def num_frames(self, n: int) -> int:
        """min over stems (items are truncated to the shortest)."""
        track = self._tracks[n]
        return min(_header_frames(os.path.join(
            self._base, track, s + ".wav")) for s in self.sources)

    def __getitem__(self, n: int):
        track = self._tracks[n]
        stems, sr = [], None
        for src in self.sources:
            wav, s = read_audio(os.path.join(self._base, track,
                                           src + ".wav"))
            wav = np.atleast_2d(np.asarray(wav, np.float32))
            if sr is not None and s != sr:
                raise ValueError(f"mixed sample rates in {track}")
            sr = s
            stems.append(wav)
        T = min(w.shape[-1] for w in stems)
        out = np.stack([w[..., :T] for w in stems])
        return torch.from_numpy(out), sr, T, track


class TEDLIUM:
    """TED-LIUM release-3 layout: ``root/TEDLIUM_release-3/data/
    {stm/<talk>.stm, sph/<talk>{ext}}``; each STM line is
    ``<talk> <chan> <speaker> <start> <end> [<label>] <transcript>``
    and indexes one segment of the talk's audio.

    ``__getitem__`` → ``(waveform segment, sample_rate, transcript,
    talk_id, speaker_id, identifier)``.  Audio ships as SPH; point
    ``ext`` at a converted tree (default ``.wav``)."""

    def __init__(self, root: str,
                 folder_in_archive: str = "TEDLIUM_release-3",
                 ext: str = ".wav"):
        data = os.path.join(root, folder_in_archive, "data")
        _require_dir(data, "TEDLIUM_release-3/data/{stm,sph}")
        self._sph = os.path.join(data, "sph")
        self.ext = ext
        self._segs: List[Tuple[str, str, float, float, str]] = []
        stm_dir = os.path.join(data, "stm")
        for nme in sorted(os.listdir(stm_dir)):
            if not nme.endswith(".stm"):
                continue
            with open(os.path.join(stm_dir, nme),
                      encoding="utf-8") as f:
                for line in f:
                    parts = line.strip().split(None, 5)
                    if len(parts) < 6:
                        continue
                    talk, _, spk, start, end, rest = parts
                    # optional leading <o,f0,male>-style label field
                    if rest.startswith("<"):
                        rest = rest.partition(">")[2].strip()
                    self._segs.append((talk, spk, float(start),
                                       float(end), rest))

    def __len__(self):
        return len(self._segs)

    def path(self, n: int) -> str:
        return os.path.join(self._sph, self._segs[n][0] + self.ext)

    def num_frames(self, n: int) -> int:
        """Segment length in samples — from the STM bounds and the
        header rate, never the (talk-long) file length."""
        talk, _, start, end, _ = self._segs[n]
        with open(self.path(n), "rb") as f:
            head = f.read(65536)
        try:
            info = audio_info(head)
        except ValueError:
            info = audio_info(self.path(n))
        sr = info["sample_rate"]
        s = int(round(start * sr))
        e = min(int(round(end * sr)), int(info["num_frames"]))
        return max(0, e - s)

    def __getitem__(self, n: int):
        talk, spk, start, end, text = self._segs[n]
        path = self.path(n)
        # a talk holds hundreds of STM segments (contiguous in
        # self._segs) — cache the one decoded talk so iteration is
        # O(talk) instead of O(segments x talk)
        if getattr(self, "_talk_path", None) != path:
            wav, sr = read_audio(path)
            self._talk_path = path
            self._talk = (np.asarray(wav, np.float32), sr)
        wav, sr = self._talk
        seg = wav[..., int(round(start * sr)):int(round(end * sr))]
        return (torch.from_numpy(seg.copy()), sr, text, talk, spk,
                f"{talk}_{n}")


class FLUENTSPEECHCOMMANDS:
    """Fluent Speech Commands layout:
    ``root/fluent_speech_commands_dataset/{data/<subset>_data.csv,
    wavs/...}`` with CSV columns ``(index, path, speakerId,
    transcription, action, object, location)``.

    ``__getitem__`` → ``(waveform, sample_rate, file_name,
    speaker_id, transcription, action, object, location)``."""

    def __init__(self, root: str, subset: str = "train"):
        if subset not in ("train", "valid", "test"):
            raise ValueError("subset must be train/valid/test")
        base = os.path.join(root, "fluent_speech_commands_dataset")
        _require_dir(base, "fluent_speech_commands_dataset/{data,wavs}")
        self._base = base
        meta = os.path.join(base, "data", f"{subset}_data.csv")
        with open(meta, newline="", encoding="utf-8") as f:
            self._rows = list(csv.DictReader(f))

    def __len__(self):
        return len(self._rows)

    def path(self, n: int) -> str:
        return os.path.join(self._base, self._rows[n]["path"])

    def num_frames(self, n: int) -> int:
        return _header_frames(self.path(n))

    def __getitem__(self, n: int):
        r = self._rows[n]
        wav, sr = read_audio(self.path(n))
        name = os.path.splitext(os.path.basename(r["path"]))[0]
        return (_tensor(wav), sr, name,
                r["speakerId"], r["transcription"], r["action"],
                r["object"], r["location"])


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


class LibriLightLimited(AudioFolder):
    """Libri-Light limited-supervision layout:
    ``root/librispeech_finetuning/{1h/<0..5>,9h}/{clean,other}/
    <spk>/<chap>/<spk>-<chap>-<utt>{ext}`` with per-chapter
    ``.trans.txt`` files.  ``subset``: ``10min`` (= ``1h/0``),
    ``1h`` (= ``1h/*``), ``10h`` (= ``1h/* + 9h``).

    ``__getitem__`` → ``(waveform, sample_rate, transcript,
    speaker_id, chapter_id, utterance_id)`` (LibriSpeech's tuple).
    The release ships FLAC (decoded natively); ``ext=None``
    auto-detects like :class:`LIBRISPEECH`."""

    def __init__(self, root: str, subset: str = "10min",
                 folder_in_archive: str = "librispeech_finetuning",
                 ext: Optional[str] = None):
        if subset not in ("10min", "1h", "10h"):
            raise ValueError("subset must be 10min/1h/10h")
        base = os.path.join(root, folder_in_archive)
        _require_dir(base, "librispeech_finetuning/{1h,9h}")
        if subset == "10min":
            parts = [os.path.join(base, "1h", "0")]
        else:
            parts = [os.path.join(base, "1h", str(i))
                     for i in range(6)
                     if os.path.isdir(os.path.join(base, "1h", str(i)))]
            if subset == "10h":
                parts.append(os.path.join(base, "9h"))
        if ext is None:
            ext = ".wav"
            for part in parts:
                for _, _, names in os.walk(part):
                    if any(n.endswith(".flac") for n in names):
                        ext = ".flac"
                        break
        self.root = base
        self.ext = ext
        self._files = []
        self._trans = {}
        for part in parts:
            for dirpath, _, names in sorted(os.walk(part)):
                for n in sorted(names):
                    if n.endswith(ext):
                        self._files.append(os.path.join(dirpath, n))
                    elif n.endswith(".trans.txt"):
                        with open(os.path.join(dirpath, n)) as f:
                            for line in f:
                                key, _, text = (
                                    line.strip().partition(" "))
                                self._trans[key] = text

    def __getitem__(self, n: int):
        path = self._files[n]
        wav, sr = self._load(path)
        utt = os.path.splitext(os.path.basename(path))[0]
        spk, chap, uid = utt.split("-")
        text = self._trans.get(utt)
        if text is None:
            raise KeyError(f"no transcript for {utt}")
        return wav, sr, text, int(spk), int(chap), int(uid)


class LibriMix:
    """LibriMix layout: ``root/Libri<N>Mix/wav<k>k/<mode>/<subset>/
    {mix_clean,mix_both,mix_single,s1..sN,noise}/*.wav``.

    ``task`` picks the mixture/source dirs (torchaudio semantics):
    ``sep_clean`` → ``mix_clean`` vs ``s1..sN``; ``sep_noisy`` →
    ``mix_both`` vs ``s1..sN``; ``enh_single`` → ``mix_single`` vs
    ``s1``; ``enh_both`` → ``mix_both`` vs ``mix_clean``.

    ``__getitem__`` → ``(sample_rate, mixture (1, T), [sources])``
    (torchaudio's tuple)."""

    def __init__(self, root: str, subset: str = "train-360",
                 num_speakers: int = 2, sample_rate: int = 8000,
                 task: str = "sep_clean", mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        if task not in ("sep_clean", "sep_noisy",
                        "enh_single", "enh_both"):
            raise ValueError(f"unsupported task {task!r}")
        base = os.path.join(root, f"Libri{num_speakers}Mix",
                            f"wav{sample_rate // 1000}k", mode, subset)
        _require_dir(base, "Libri2Mix/wav8k/min/<subset>/{mix_*,s*}")
        mix_dir = {"sep_clean": "mix_clean", "sep_noisy": "mix_both",
                   "enh_single": "mix_single",
                   "enh_both": "mix_both"}[task]
        if task == "enh_single":
            src_dirs = ["s1"]
        elif task == "enh_both":
            src_dirs = ["mix_clean"]
        else:
            src_dirs = [f"s{i + 1}" for i in range(num_speakers)]
        self._mix_dir = os.path.join(base, mix_dir)
        self._src_dirs = [os.path.join(base, d) for d in src_dirs]
        _require_dir(self._mix_dir, f"<subset>/{mix_dir}/*.wav")
        self.sample_rate = sample_rate
        self.task = task
        self._names = sorted(
            n for n in os.listdir(self._mix_dir) if n.endswith(".wav"))

    def __len__(self):
        return len(self._names)

    def path(self, n: int) -> str:
        return os.path.join(self._mix_dir, self._names[n])

    def num_frames(self, n: int) -> int:
        return _header_frames(self.path(n))

    @staticmethod
    def _read(path):
        wav, sr = read_audio(path)
        return _tensor(np.atleast_2d(wav)), sr

    def __getitem__(self, n: int):
        name = self._names[n]
        mix, sr = self._read(self.path(n))
        if sr != self.sample_rate:
            raise ValueError(
                f"{name}: header rate {sr} != dataset rate "
                f"{self.sample_rate}")
        srcs = []
        for d in self._src_dirs:
            s, ssr = self._read(os.path.join(d, name))
            if ssr != sr:
                raise ValueError(f"mixed rates for {name}")
            srcs.append(s)
        return sr, mix, srcs


class DR_VCTK:
    """Device-Recorded VCTK layout: ``root/DR-VCTK/DR-VCTK/
    {clean_<subset>set_wav_16k, device-recorded_<subset>set_wav_16k,
    configurations/<subset>_ch_log.txt}`` where the config is a
    tab-separated ``(file name, main source, channel idx)`` table
    with one header line.

    ``__getitem__`` → ``(clean_waveform, clean_sr, noisy_waveform,
    noisy_sr, filename, source, channel_id)`` (torchaudio's tuple)."""

    def __init__(self, root: str, subset: str = "train"):
        if subset not in ("train", "test"):
            raise ValueError("subset must be 'train' or 'test'")
        base = os.path.join(root, "DR-VCTK", "DR-VCTK")
        _require_dir(base, "DR-VCTK/DR-VCTK/{clean_*,device-recorded_*}")
        self._clean = os.path.join(base, f"clean_{subset}set_wav_16k")
        self._noisy = os.path.join(
            base, f"device-recorded_{subset}set_wav_16k")
        cfg = os.path.join(base, "configurations",
                           f"{subset}_ch_log.txt")
        if not os.path.isfile(cfg):
            raise FileNotFoundError(
                f"{cfg} does not exist. Datasets are never "
                "downloaded; place the corpus there.")
        self._config = {}
        with open(cfg, encoding="utf-8") as f:
            rows = [r for r in csv.reader(f, delimiter="\t") if r]
        for row in rows[1:]:           # skip the header line
            if len(row) >= 3:
                self._config[row[0]] = (row[1], int(row[2]))
        self._names = sorted(
            n for n in os.listdir(self._clean) if n.endswith(".wav"))

    def __len__(self):
        return len(self._names)

    def path(self, n: int) -> str:
        return os.path.join(self._clean, self._names[n])

    def num_frames(self, n: int) -> int:
        return _header_frames(self.path(n))

    def __getitem__(self, n: int):
        name = self._names[n]
        clean, csr = read_audio(self.path(n))
        noisy, nsr = read_audio(os.path.join(self._noisy, name))
        source, channel = self._config.get(name, ("", 0))
        return (_tensor(clean), csr, _tensor(noisy), nsr,
                name, source, channel)


class IEMOCAP:
    """IEMOCAP layout: ``root/IEMOCAP/Session<n>/sentences/wav/
    <dialog>/<utt>.wav`` with labels in ``Session<n>/dialog/
    EmoEvaluation/<dialog>.txt`` (lines ``[start - end]\\t<utt>\\t
    <label>\\t[v, a, d]``).  Only utterances labeled
    neu/hap/ang/sad/exc/fru are kept (torchaudio semantics);
    ``utterance_type`` filters scripted vs improvised dialogs.

    ``__getitem__`` → ``(waveform, sample_rate, file_name, label,
    speaker)``."""

    _LABELS = ("neu", "hap", "ang", "sad", "exc", "fru")

    def __init__(self, root: str,
                 sessions: Sequence[int] = (1, 2, 3, 4, 5),
                 utterance_type: Optional[str] = None):
        if utterance_type not in (None, "scripted", "improvised"):
            raise ValueError(
                "utterance_type must be None/'scripted'/'improvised'")
        base = os.path.join(root, "IEMOCAP")
        _require_dir(base, "IEMOCAP/Session<n>/{sentences,dialog}")
        self._items: List[Tuple[str, str, str, str]] = []
        for sess in sessions:
            sdir = os.path.join(base, f"Session{int(sess)}")
            wav_root = os.path.join(sdir, "sentences", "wav")
            lab_root = os.path.join(sdir, "dialog", "EmoEvaluation")
            if not os.path.isdir(wav_root):
                continue
            labels = {}
            if os.path.isdir(lab_root):
                for nme in sorted(os.listdir(lab_root)):
                    if not nme.endswith(".txt"):
                        continue
                    with open(os.path.join(lab_root, nme),
                              encoding="utf-8", errors="replace") as f:
                        for line in f:
                            if not line.startswith("["):
                                continue
                            parts = line.strip().split("\t")
                            if len(parts) >= 3:
                                labels[parts[1]] = parts[2]
            for dialog in sorted(os.listdir(wav_root)):
                if utterance_type == "scripted" \
                        and "script" not in dialog:
                    continue
                if utterance_type == "improvised" \
                        and "impro" not in dialog:
                    continue
                ddir = os.path.join(wav_root, dialog)
                if not os.path.isdir(ddir):
                    continue
                for nme in sorted(os.listdir(ddir)):
                    if not nme.endswith(".wav"):
                        continue
                    utt = nme[:-4]
                    label = labels.get(utt)
                    if label in self._LABELS:
                        self._items.append(
                            (os.path.join(ddir, nme), utt, label,
                             utt.split("_")[0]))

    def __len__(self):
        return len(self._items)

    def path(self, n: int) -> str:
        return self._items[n][0]

    def num_frames(self, n: int) -> int:
        return _header_frames(self.path(n))

    def __getitem__(self, n: int):
        path, utt, label, speaker = self._items[n]
        wav, sr = read_audio(path)
        return _tensor(wav), sr, utt, label, speaker


class QUESST14:
    """QUESST 2014 layout: ``root/quesst14Database/{Audio,
    dev_queries, eval_queries, scoring/language_key_*.lst}``; each
    ``.lst`` line is ``quesst14Database/<dir>/<file>.wav <language>``.

    ``subset``: ``docs`` (utterances) / ``dev`` / ``eval`` (queries);
    ``language`` filters (``None`` keeps all).

    ``__getitem__`` → ``(waveform, sample_rate, file_name)``
    (torchaudio's tuple; ``file_name`` is the stem)."""

    def __init__(self, root: str, subset: str = "docs",
                 language: Optional[str] = "nnenglish"):
        if subset not in ("docs", "dev", "eval"):
            raise ValueError("subset must be docs/dev/eval")
        base = os.path.join(root, "quesst14Database")
        _require_dir(base, "quesst14Database/{Audio,scoring}")
        key = {"docs": "language_key_utterances.lst",
               "dev": "language_key_dev.lst",
               "eval": "language_key_eval.lst"}[subset]
        lst = os.path.join(base, "scoring", key)
        if not os.path.isfile(lst):
            raise FileNotFoundError(
                f"{lst} does not exist. Datasets are never "
                "downloaded; place the corpus there.")
        self._files: List[str] = []
        with open(lst, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                relpath, lang = parts[0], parts[1]
                if language is not None and lang != language:
                    continue
                self._files.append(os.path.join(root, relpath))

    def __len__(self):
        return len(self._files)

    def path(self, n: int) -> str:
        return self._files[n]

    def num_frames(self, n: int) -> int:
        return _header_frames(self.path(n))

    def __getitem__(self, n: int):
        path = self._files[n]
        wav, sr = read_audio(path)
        name = os.path.splitext(os.path.basename(path))[0]
        return _tensor(wav), sr, name


class Snips(AudioFolder):
    """SNIPS smart-lights SLU layout: ``root/SNIPS/<subset>/
    <speaker>-snips-<subset>-<n>{ext}`` plus the IOB transcript file
    ``root/SNIPS/all.iob.snips.txt`` whose lines are
    ``BOS <words> EOS\\tO <iob tags> <intent>``.

    Transcript keying is reconstructed [ref-recon: torchaudio
    datasets.Snips — UNVERIFIED, mount empty]: a line whose first
    token is not ``BOS`` is treated as utterance-keyed
    (``<utt_id> BOS ... EOS\\t...``); otherwise lines map
    positionally onto the sorted audio list of the subset.

    ``__getitem__`` → ``(waveform, sample_rate, file_name,
    transcript, iob, intent)``."""

    def __init__(self, root: str, subset: str = "train",
                 speakers: Optional[Sequence[str]] = None,
                 audio_format: str = ".wav"):
        if subset not in ("train", "valid", "test"):
            raise ValueError("subset must be train/valid/test")
        base = os.path.join(root, "SNIPS")
        _require_dir(base, "SNIPS/{train,valid,test,all.iob.snips.txt}")
        super().__init__(os.path.join(base, subset), audio_format)
        # positional transcript lines map onto the UNFILTERED sorted
        # list — record each file's corpus position BEFORE any
        # speaker filter, or filtered item n would silently receive
        # unfiltered line n's transcript
        self._corpus_pos = {p: i for i, p in enumerate(self._files)}
        if speakers is not None:
            speakers = set(speakers)
            self._files = [p for p in self._files
                           if os.path.basename(p).split("-")[0]
                           in speakers]
        self._keyed = {}
        self._ordered: List[Tuple[str, str, str]] = []
        trans = os.path.join(base, "all.iob.snips.txt")
        if os.path.isfile(trans):
            with open(trans, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    key = None
                    if not line.startswith("BOS "):
                        key, _, line = line.partition(" ")
                    inp, _, out = line.partition("\t")
                    words = inp.split()
                    if words[:1] == ["BOS"]:
                        words = words[1:]
                    if words[-1:] == ["EOS"]:
                        words = words[:-1]
                    tags = out.split()
                    if tags[:1] == ["O"]:
                        tags = tags[1:]
                    intent = tags[-1] if tags else ""
                    iob = " ".join(tags[:-1])
                    rec = (" ".join(words), iob, intent)
                    if key is not None:
                        self._keyed[key] = rec
                    else:
                        self._ordered.append(rec)

    def __getitem__(self, n: int):
        path = self._files[n]
        wav, sr = self._load(path)
        name = os.path.splitext(os.path.basename(path))[0]
        rec = self._keyed.get(name)
        if rec is None:
            pos = self._corpus_pos[path]
            if pos < len(self._ordered):
                rec = self._ordered[pos]
        if rec is None:
            raise KeyError(f"no transcript for {name}")
        text, iob, intent = rec
        return (_tensor(wav), sr, name,
                text, iob, intent)


def _voxceleb1_file_id(rel: str) -> str:
    """``id10001/1zcIwhmdeo4/00001.wav`` → the torchaudio file id
    ``id10001-1zcIwhmdeo4-00001``."""
    return "-".join(os.path.splitext(rel)[0].split("/"))


class VoxCeleb1Identification:
    """VoxCeleb1 speaker-identification layout: ``root/wav/
    id<NNNNN>/<video>/<file>.wav`` plus the official
    ``iden_split.txt`` (lines ``<subset_id> <relpath>``, 1=train,
    2=dev, 3=test) placed at ``root/iden_split.txt`` (or pass
    ``meta_path``).

    ``__getitem__`` → ``(waveform, sample_rate, speaker_id int,
    file_id)`` (torchaudio's tuple)."""

    _SUBSETS = {"train": "1", "dev": "2", "test": "3"}

    def __init__(self, root: str, subset: str = "train",
                 meta_path: Optional[str] = None):
        if subset not in self._SUBSETS:
            raise ValueError("subset must be train/dev/test")
        _require_dir(os.path.join(root, "wav"),
                     "wav/id*/<video>/*.wav + iden_split.txt")
        meta = meta_path or os.path.join(root, "iden_split.txt")
        if not os.path.isfile(meta):
            raise FileNotFoundError(
                f"{meta} does not exist. Datasets are never "
                "downloaded; place iden_split.txt there.")
        want = self._SUBSETS[subset]
        self._root = os.path.join(root, "wav")
        self._rels: List[str] = []
        with open(meta, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2 and parts[0] == want:
                    self._rels.append(parts[1])

    def __len__(self):
        return len(self._rels)

    def path(self, n: int) -> str:
        return os.path.join(self._root, self._rels[n])

    def num_frames(self, n: int) -> int:
        return _header_frames(self.path(n))

    def __getitem__(self, n: int):
        rel = self._rels[n]
        wav, sr = read_audio(self.path(n))
        spk = int(rel.split("/", 1)[0][2:])
        return (_tensor(wav), sr, spk,
                _voxceleb1_file_id(rel))


class VoxCeleb1Verification:
    """VoxCeleb1 verification pairs: same audio tree as
    :class:`VoxCeleb1Identification` plus the official trial list
    ``veri_test.txt`` (lines ``<label> <relpath1> <relpath2>``) at
    ``root/veri_test.txt`` (or pass ``meta_path``).

    ``__getitem__`` → ``(waveform_spk1, waveform_spk2, sample_rate,
    label int, file_id_spk1, file_id_spk2)`` (torchaudio's tuple)."""

    def __init__(self, root: str, meta_path: Optional[str] = None):
        _require_dir(os.path.join(root, "wav"),
                     "wav/id*/<video>/*.wav + veri_test.txt")
        meta = meta_path or os.path.join(root, "veri_test.txt")
        if not os.path.isfile(meta):
            raise FileNotFoundError(
                f"{meta} does not exist. Datasets are never "
                "downloaded; place veri_test.txt there.")
        self._root = os.path.join(root, "wav")
        self._trials: List[Tuple[int, str, str]] = []
        with open(meta, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) == 3:
                    self._trials.append(
                        (int(parts[0]), parts[1], parts[2]))

    def __len__(self):
        return len(self._trials)

    def __getitem__(self, n: int):
        label, rel1, rel2 = self._trials[n]
        wav1, sr1 = read_audio(os.path.join(self._root, rel1))
        wav2, sr2 = read_audio(os.path.join(self._root, rel2))
        if sr1 != sr2:
            raise ValueError(f"mixed sample rates in trial {n}")
        return (_tensor(wav1), _tensor(wav2), sr1, label,
                _voxceleb1_file_id(rel1), _voxceleb1_file_id(rel2))


# -- batching -------------------------------------------------------
def _shuffled(items, shuffle_key):
    """``items`` (a list or a 1-D array) in the order ``shuffle_key``
    gives: an int seeds ``np.random.default_rng``, as the JAX package
    does (shuffling ``items`` in place); a ``torch.Generator`` draws a
    ``randperm`` on its device (a new list)."""
    if isinstance(shuffle_key, torch.Generator):
        perm = torch.randperm(len(items), generator=shuffle_key,
                              device=shuffle_key.device).tolist()
        return [items[i] for i in perm]
    if isinstance(shuffle_key, (int, np.integer)) \
            and not isinstance(shuffle_key, bool):
        np.random.default_rng(int(shuffle_key)).shuffle(items)
        return items
    raise TypeError(
        "shuffle_key must be an int seed or a torch.Generator, got "
        f"{type(shuffle_key).__name__}")


def pad_collate(waveforms: Sequence):
    """Right-zero-pad 1-D/2-D clips (tensors or arrays) to the batch max:
    → ``(batch (B, [C,] Tmax) float32, lengths (B,) int32)`` CPU
    tensors."""
    if not waveforms:
        raise ValueError("empty batch")
    arrs = [torch.atleast_2d(torch.as_tensor(w).to(torch.float32).cpu())
            for w in waveforms]
    C = arrs[0].shape[0]
    if any(a.shape[0] != C for a in arrs):
        raise ValueError("inconsistent channel counts in batch")
    lengths = torch.tensor([a.shape[-1] for a in arrs], dtype=torch.int32)
    T = int(lengths.max())
    out = torch.zeros((len(arrs), C, T), dtype=torch.float32)
    for i, a in enumerate(arrs):
        out[i, :, :a.shape[-1]] = a
    squeeze = all(len(w.shape) == 1 for w in waveforms)
    return (out[:, 0] if squeeze else out), lengths


def bucket_indices(lengths: Sequence[int], batch_size: int,
                   shuffle_key=None) -> List[List[int]]:
    """Group indices into length-sorted batches (minimizes padding);
    optional deterministic batch-order shuffle via an int seed or a
    ``torch.Generator``."""
    order = np.argsort(np.asarray(lengths), kind="stable")
    batches = [order[i:i + batch_size].tolist()
               for i in range(0, len(order), batch_size)]
    if shuffle_key is not None:
        batches = _shuffled(batches, shuffle_key)
    return batches


def batch_iterator(dataset, batch_size: int, shuffle_key=None,
                   bucket: bool = False, drop_last: bool = False,
                   collate: Optional[Callable] = pad_collate
                   ) -> Iterator:
    """Iterate a dataset in batches.  Yields ``(collated_waveforms,
    lengths, rest)`` where ``rest`` is the list of per-item metadata
    tuples (everything after ``(waveform, sample_rate)``), or the raw
    item list when ``collate=None``."""
    n = len(dataset)
    if bucket:
        nf = getattr(dataset, "num_frames", None)
        if callable(nf):
            # header-only lengths: bucketing must not decode the
            # whole corpus up front (and then again per batch)
            lens = [int(nf(i)) for i in range(n)]
        else:
            lens = [int(dataset[i][0].shape[-1]) for i in range(n)]
        batches = bucket_indices(lens, batch_size, shuffle_key)
    else:
        order = np.arange(n)
        if shuffle_key is not None:
            order = np.asarray(_shuffled(order, shuffle_key))
        batches = [order[i:i + batch_size].tolist()
                   for i in range(0, n, batch_size)]
    for idx in batches:
        if drop_last and len(idx) < batch_size:
            continue
        items = [dataset[i] for i in idx]
        if collate is None:
            yield items
            continue
        rates = {int(it[1]) for it in items}
        if len(rates) > 1:
            raise ValueError(
                f"mixed sample rates in one batch {sorted(rates)} — "
                "resample the corpus to a common rate first")
        wavs, lengths = collate([it[0] for it in items])
        yield wavs, lengths, [it[2:] for it in items]


# torchaudio's CamelCase name for the same parser
FluentSpeechCommands = FLUENTSPEECHCOMMANDS
