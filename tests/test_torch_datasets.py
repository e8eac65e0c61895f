"""Parity of the port's ``datasets`` with the JAX package's, on the CPU:
each of the 21 layout parsers on a tiny synthesised tree (the 19 the port
lacked, the ``FluentSpeechCommands`` alias and ``CMUDict``), the batching
helpers, and the int-seeded shuffles (the JAX package's permutations).

Both packages index the same tree.  Every item of the port's must equal
the JAX package's: waveforms as CPU float32 tensors equal to its NumPy
arrays bitwise, metadata equal.  The trees are written once per module
with the JAX package's codecs (WAV and, for LibriSpeech, FLAC).
"""
import os

import numpy as np
import pytest
import torch

from torchaudio_contrib_tpu import datasets as JD
from torchaudio_contrib_tpu.io import write_wav, write_flac
from torchaudio_contrib_tpu_torch import datasets as TD

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

_RNG = np.random.default_rng(1305)


def _wav(path, n, sr=16000, ch=1, flac=False):
    x = (_RNG.integers(-20000, 20000, (ch, n)) / 32768.0).astype(np.float32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    (write_flac if flac else write_wav)(path, x, sr)


def _text(path, body, mode="w"):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, mode) as f:
        f.write(body)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """One directory holding every corpus's layout."""
    r = str(tmp_path_factory.mktemp("corpora"))
    j = os.path.join
    # LibriSpeech (FLAC, two chapters) and a converted WAV tree
    for fmt, url in ((True, "test-clean"), (False, "dev-clean")):
        for spk, chap, lens in ((84, 121123, (1600, 2400, 800)),
                                (174, 50561, (1200, 700))):
            d = j(r, "LibriSpeech", url, str(spk), str(chap))
            lines = []
            for i, n in enumerate(lens):
                utt = f"{spk}-{chap}-{i:04d}"
                _wav(j(d, utt + (".flac" if fmt else ".wav")), n, flac=fmt)
                lines.append(f"{utt} WORDS OF {spk} {i}")
            _text(j(d, f"{spk}-{chap}.trans.txt"), "\n".join(lines))
    # AudioFolder
    _wav(j(r, "folder", "a", "x.wav"), 500)
    _wav(j(r, "folder", "y.wav"), 700, ch=2)
    # LJSpeech
    rows = []
    for i in range(2):
        _wav(j(r, "LJSpeech-1.1", "wavs", f"LJ001-{i:04d}.wav"), 1000 + i,
             22050)
        rows.append(f"LJ001-{i:04d}|raw {i}|normalized {i}")
    _text(j(r, "LJSpeech-1.1", "metadata.csv"), "\n".join(rows))
    # Speech Commands
    base = j(r, "SpeechCommands", "speech_commands_v0.02")
    for label in ("yes", "no"):
        _wav(j(base, label, "spkA_nohash_0.wav"), 1600)
        _wav(j(base, label, "spkB_nohash_3.wav"), 1500)
    _wav(j(base, "_background_noise_", "pink.wav"), 3200)
    # YesNo
    _wav(j(r, "waves_yesno", "0_1_0_1_1_0_1_0.wav"), 800, 8000)
    _wav(j(r, "waves_yesno", "1_1_0_0_1_0_1_1.wav"), 900, 8000)
    # CMU ARCTIC
    base = j(r, "ARCTIC", "cmu_us_aew_arctic")
    lines = []
    for i in range(2):
        _wav(j(base, "wav", f"arctic_a{i:04d}.wav"), 900 + i * 50)
        lines.append(f'( arctic_a{i:04d} "Sentence number {i}." )')
    _text(j(base, "etc", "txt.done.data"), "\n".join(lines))
    # LibriTTS
    base = j(r, "LibriTTS", "dev-clean", "19", "198")
    for k in range(2):
        utt = f"19_198_000000_00000{k}"
        _wav(j(base, utt + ".wav"), 1200 + k, 24000)
        _text(j(base, utt + ".original.txt"), f"Original, text {k}!")
        _text(j(base, utt + ".normalized.txt"), f"original text {k}")
    # VCTK 0.92
    base = j(r, "VCTK-Corpus-0.92")
    for utt, has_txt in (("001", True), ("002", False), ("003", True)):
        for mic in ("mic1", "mic2"):
            _wav(j(base, "wav48_silence_trimmed", "p225",
                   f"p225_{utt}_{mic}.wav"), 700)
        if has_txt:
            _text(j(base, "txt", "p225", f"p225_{utt}.txt"),
                  f"Please call Stella {utt}.")
    # GTZAN
    for genre in ("blues", "rock"):
        _wav(j(r, "genres", genre, f"{genre}.00000.wav"), 600, 22050)
    # Common Voice
    _text(j(r, "cv", "train.tsv"), "client_id\tpath\tsentence\n"
          "abc\tclip_0.mp3\thello there\ndef\tclip_1.mp3\tgood bye\n")
    for i in range(2):
        _wav(j(r, "cv", "clips", f"clip_{i}.wav"), 400 + i * 100)
    # MUSDB18-HQ
    track = j(r, "musdb", "train", "A Band - Song")
    for i, src in enumerate(("mixture", "bass", "drums", "other",
                             "vocals")):
        _wav(j(track, f"{src}.wav"), 2000 + (i % 2), 44100, ch=2)
    # TED-LIUM 3
    data = j(r, "TEDLIUM_release-3", "data")
    _wav(j(data, "sph", "TalkA.wav"), 3 * 16000)
    _text(j(data, "stm", "TalkA.stm"),
          "TalkA 1 speaker_a 0.50 1.25 <o,f0,male> hello world\n"
          "TalkA 1 speaker_a 1.25 2.00 second segment here\n")
    # Fluent Speech Commands
    base = j(r, "fluent_speech_commands_dataset")
    _wav(j(base, "wavs", "speakers", "s1", "u1.wav"), 800)
    _wav(j(base, "wavs", "speakers", "s2", "u2.wav"), 850)
    _text(j(base, "data", "train_data.csv"),
          ",path,speakerId,transcription,action,object,location\n"
          "0,wavs/speakers/s1/u1.wav,s1,turn on the lights,activate,"
          "lights,none\n"
          "1,wavs/speakers/s2/u2.wav,s2,volume up,increase,volume,none\n")
    # CMUdict
    _text(j(r, "cmudict", "cmudict-0.7b"),
          ";;; comment line\n!EXCLAMATION-POINT  EH2 K S K L AH0\n"
          "'BOUT  B AW1 T\nHELLO  HH AH0 L OW1\nHELLO(1)  HH EH0 L OW1\n"
          "WORLD  W ER1 L D\n")
    _text(j(r, "cmudict", "cmudict-0.7b.symbols"), "AH\nEH\nHH\n")
    # Libri-Light limited
    base = j(r, "librispeech_finetuning")
    for part, spk in (("1h/0", 19), ("1h/1", 26), ("9h", 39)):
        d = j(base, part, "clean", str(spk), "1000")
        utt = f"{spk}-1000-0000"
        _wav(j(d, utt + ".wav"), 1200)
        _text(j(d, f"{spk}-1000.trans.txt"), f"{utt} TEXT {spk}")
    # LibriMix
    base = j(r, "Libri2Mix", "wav8k", "min", "dev")
    for d in ("mix_clean", "mix_both", "mix_single", "s1", "s2"):
        for i in range(2):
            _wav(j(base, d, f"utt{i}.wav"), 640, 8000)
    # DR-VCTK
    base = j(r, "DR-VCTK", "DR-VCTK")
    for i in range(2):
        for d in ("clean_trainset_wav_16k",
                  "device-recorded_trainset_wav_16k"):
            _wav(j(base, d, f"p226_00{i}.wav"), 800 + i)
    _text(j(base, "configurations", "train_ch_log.txt"),
          "File Name\tMain Source\tChannel Idx\n"
          "p226_000.wav\toffice1\t1\np226_001.wav\toffice2\t5\n")
    # IEMOCAP
    sess = j(r, "IEMOCAP", "Session1")
    for i in range(3):
        _wav(j(sess, "sentences", "wav", "Ses01F_impro01",
               f"Ses01F_impro01_F00{i}.wav"), 700 + i)
    _text(j(sess, "dialog", "EmoEvaluation", "Ses01F_impro01.txt"),
          "% header\n"
          "[0.1 - 0.5]\tSes01F_impro01_F000\tneu\t[2.5, 2.5, 2.5]\n"
          "[0.6 - 0.9]\tSes01F_impro01_F001\thap\t[3.5, 3.0, 3.0]\n"
          "[1.0 - 1.4]\tSes01F_impro01_F002\txxx\t[2.0, 2.0, 2.0]\n")
    # QUESST14
    base = j(r, "quesst14Database")
    lines = []
    for i, lang in enumerate(("nnenglish", "czech", "nnenglish")):
        name = f"quesst14_0000{i}.wav"
        _wav(j(base, "Audio", name), 640 + i, 8000)
        lines.append(f"quesst14Database/Audio/{name} {lang}")
    _text(j(base, "scoring", "language_key_utterances.lst"),
          "\n".join(lines))
    # SNIPS, keyed and positional transcripts
    for sub in ("train", "valid"):
        for i, spk in enumerate(("Aditi", "Brian", "Clara")):
            _wav(j(r, "SNIPS", sub, f"{spk}-snips-{sub}-{i}.wav"), 900 + i)
    _text(j(r, "SNIPS", "all.iob.snips.txt"),
          "Aditi-snips-train-0 BOS turn on the light EOS\t"
          "O O O O B-device SwitchLightOn\n"
          "Brian-snips-train-1 BOS dim the light EOS\t"
          "O O O B-device SetLightBrightness\n"
          "Clara-snips-train-2 BOS lights off EOS\tO O O SwitchLightOff\n"
          "BOS zero EOS\tO IntentA\nBOS one EOS\tO IntentB\n"
          "BOS two EOS\tO IntentC\n")
    # VoxCeleb1
    rels = []
    for spk, vid in ((10001, "abc"), (10002, "xyz"), (10003, "q9")):
        _wav(j(r, "vox", "wav", f"id{spk}", vid, "00001.wav"), 600)
        rels.append(f"id{spk}/{vid}/00001.wav")
    _text(j(r, "vox", "iden_split.txt"),
          f"1 {rels[0]}\n3 {rels[1]}\n1 {rels[2]}\n")
    _text(j(r, "vox", "veri_test.txt"),
          f"1 {rels[0]} {rels[1]}\n0 {rels[1]} {rels[2]}\n")
    return r


# class name, constructor arguments (relative to ``root``)
CASES = [
    ("AudioFolder", ("folder",), {}),
    ("LIBRISPEECH", ("",), dict(url="test-clean")),
    ("LIBRISPEECH", ("",), dict(url="dev-clean")),
    ("LJSPEECH", ("",), {}),
    ("SPEECHCOMMANDS", ("",), {}),
    ("YESNO", ("",), {}),
    ("CMUARCTIC", ("",), {}),
    ("LIBRITTS", ("",), dict(url="dev-clean")),
    ("VCTK_092", ("",), {}),
    ("VCTK_092", ("",), dict(mic_id="mic1")),
    ("GTZAN", ("",), {}),
    ("COMMONVOICE", ("cv",), {}),
    ("MUSDB_HQ", ("musdb",), {}),
    ("MUSDB_HQ", ("musdb",), dict(sources=["mixture", "vocals"])),
    ("TEDLIUM", ("",), {}),
    ("FLUENTSPEECHCOMMANDS", ("",), {}),
    ("FluentSpeechCommands", ("",), {}),
    ("CMUDict", ("cmudict",), {}),
    ("CMUDict", ("cmudict",), dict(exclude_punctuations=False)),
    ("LibriLightLimited", ("",), dict(subset="10min")),
    ("LibriLightLimited", ("",), dict(subset="10h")),
    ("LibriMix", ("",), dict(subset="dev")),
    ("LibriMix", ("",), dict(subset="dev", task="enh_single")),
    ("LibriMix", ("",), dict(subset="dev", task="enh_both")),
    ("DR_VCTK", ("",), {}),
    ("IEMOCAP", ("",), {}),
    ("IEMOCAP", ("",), dict(utterance_type="scripted")),
    ("QUESST14", ("",), {}),
    ("QUESST14", ("",), dict(language=None)),
    ("Snips", ("",), dict(subset="train")),
    ("Snips", ("",), dict(subset="valid", speakers=["Clara"])),
    ("VoxCeleb1Identification", ("vox",), {}),
    ("VoxCeleb1Identification", ("vox",), dict(subset="test")),
    ("VoxCeleb1Verification", ("vox",), {}),
]
CASE_IDS = [f"{c[0]}-{i}" for i, c in enumerate(CASES)]


def _same(got, want):
    """``got`` (the port's item) equals ``want`` (the JAX package's):
    tensors are CPU float32 and equal to the arrays bitwise."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, torch.Tensor), type(got)
        assert got.device.type == "cpu" and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got == want


def test_the_parsers_are_the_jax_packages():
    assert TD.__all__ == JD.__all__
    assert TD.FluentSpeechCommands is TD.FLUENTSPEECHCOMMANDS


@pytest.mark.parametrize("name,args,kw", CASES, ids=CASE_IDS)
def test_items_equal_the_jax_packages(root, name, args, kw):
    args = tuple(os.path.join(root, a) for a in args)
    want = getattr(JD, name)(*args, **kw)
    got = getattr(TD, name)(*args, **kw)
    assert len(got) == len(want)
    assert len(want) > 0 or kw == dict(utterance_type="scripted")
    for i in range(len(want)):
        _same(got[i], want[i])
        if hasattr(want, "num_frames"):
            assert got.num_frames(i) == want.num_frames(i)
        if hasattr(want, "path"):
            assert got.path(i) == want.path(i)
    if name == "CMUDict":
        assert got.symbols == want.symbols


def test_num_frames_reads_the_header_only(root, monkeypatch):
    ds = TD.LIBRISPEECH(root, url="test-clean")
    lengths = [ds.num_frames(i) for i in range(len(ds))]
    assert lengths == [ds[i][0].shape[-1] for i in range(len(ds))]
    monkeypatch.setattr(TD, "read_audio", lambda *a: pytest.fail("decoded"))
    assert [ds.num_frames(i) for i in range(len(ds))] == lengths


@pytest.mark.parametrize("name,kw", [
    ("LIBRISPEECH", {}), ("VCTK_092", dict(mic_id="mic3")),
    ("MUSDB_HQ", dict(subset="dev")), ("LibriMix", dict(task="nope")),
    ("LibriLightLimited", dict(subset="5h")),
    ("FLUENTSPEECHCOMMANDS", dict(subset="eval")),
    ("QUESST14", dict(subset="queries")), ("COMMONVOICE", {}),
])
def test_errors_are_the_jax_packages(tmp_path, name, kw):
    """Never a download: a missing tree raises FileNotFoundError, a bad
    argument ValueError, as in the JAX package."""
    with pytest.raises((FileNotFoundError, ValueError)) as want:
        getattr(JD, name)(str(tmp_path), **kw)
    with pytest.raises(want.type) as got:
        getattr(TD, name)(str(tmp_path), **kw)
    if want.type is FileNotFoundError:
        assert "never downloaded" in str(got.value)


def test_pad_collate_matches_the_jax_package():
    rng = np.random.default_rng(3)
    mono = [rng.standard_normal(n).astype(np.float32) for n in (100, 60, 80)]
    stereo = [rng.standard_normal((2, n)).astype(np.float32)
              for n in (70, 90)]
    for items in (mono, stereo):
        want_b, want_l = JD.pad_collate(items)
        for arg in (items, [torch.from_numpy(a) for a in items]):
            got_b, got_l = TD.pad_collate(arg)
            assert got_l.dtype == torch.int32
            np.testing.assert_array_equal(got_b.numpy(), want_b)
            np.testing.assert_array_equal(got_l.numpy(), want_l)
    for mod in (JD, TD):
        with pytest.raises(ValueError, match="channel"):
            mod.pad_collate([np.zeros(10, np.float32),
                             np.zeros((2, 10), np.float32)])
        with pytest.raises(ValueError, match="empty"):
            mod.pad_collate([])


@pytest.mark.parametrize("seed", [None, 0, 3, 12345])
def test_bucket_indices_match_the_jax_package(seed):
    lengths = np.random.default_rng(7).integers(100, 1000, 23).tolist()
    assert TD.bucket_indices(lengths, 4, seed) \
        == JD.bucket_indices(lengths, 4, seed)


@pytest.mark.parametrize("seed", [None, 5])
@pytest.mark.parametrize("bucket", [False, True])
def test_batch_iterator_matches_the_jax_package(root, seed, bucket):
    """Same batches in the same order for an int seed: waveforms, lengths
    and metadata."""
    jds = JD.LIBRISPEECH(root, url="test-clean")
    tds = TD.LIBRISPEECH(root, url="test-clean")
    want = list(JD.batch_iterator(jds, 2, shuffle_key=seed, bucket=bucket))
    got = list(TD.batch_iterator(tds, 2, shuffle_key=seed, bucket=bucket))
    assert len(got) == len(want) == 3
    for (gw, gl, gr), (ww, wl, wr) in zip(got, want):
        np.testing.assert_array_equal(gw.numpy(), ww)
        np.testing.assert_array_equal(gl.numpy(), wl)
        assert gr == wr
    assert len(list(TD.batch_iterator(tds, 2, drop_last=True))) == 2
    raw = next(TD.batch_iterator(tds, 2, collate=None))
    _same(raw, next(JD.batch_iterator(jds, 2, collate=None)))


def test_torch_generator_shuffles(root):
    ds = TD.LIBRISPEECH(root, url="test-clean")
    for bucket in (False, True):
        got = [r[1:] for _, _, rest in TD.batch_iterator(
            ds, 2, shuffle_key=torch.Generator().manual_seed(4),
            bucket=bucket) for r in rest]
        assert sorted(got) == sorted(ds[i][3:] for i in range(len(ds)))
    lengths = list(range(40))
    a = TD.bucket_indices(lengths, 4, torch.Generator().manual_seed(1))
    b = TD.bucket_indices(lengths, 4, torch.Generator().manual_seed(1))
    assert a == b and sorted(a) == TD.bucket_indices(lengths, 4)
    assert a != TD.bucket_indices(lengths, 4)
    with pytest.raises(TypeError, match="int seed or a torch.Generator"):
        TD.bucket_indices(lengths, 4, 1.5)


def test_batch_iterator_rejects_mixed_rates(tmp_path):
    for i, sr in enumerate((16000, 16000, 44100)):
        _wav(str(tmp_path / f"f{i}.wav"), 800, sr)
    with pytest.raises(ValueError, match="mixed sample rates"):
        list(TD.batch_iterator(TD.AudioFolder(str(tmp_path)), batch_size=3))
