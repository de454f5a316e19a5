"""The port's CLIP BPE tokenizer, written without ``transformers``,
against the JAX package's ``HFCLIPTokenizer`` (``transformers``' own, on
a host without ``ftfy``) on SDXL's two tokenizer folders, the second
padding with "!": ids, ``encode``, ``encode_word``, ``decode`` and the
P2P word alignment."""

import numpy as np
import pytest

from omg_tpu.control import p2p as jp2p
from omg_tpu.text.tokenizer import HFCLIPTokenizer as JaxTokenizer
from omg_tpu_torch.control import p2p
from omg_tpu_torch.text.tokenizer import HFCLIPTokenizer

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (TOKENIZER_CORPUS, learn_merges,
                                write_clip_tokenizer)

PROMPTS = [
    "Close-up photo of the cool man and beautiful woman at the beach, 4k.",
    "the man's hat!! they'll SMILE... 123 45,6 (and) [x]-*-[y]",
    "café naïve Ångström  \t\n  résumé, é combining",
    "東京 の 猫 and 한국어 text, ½ ⅔ Ⅻ ٣",
    "emoji 😀 mixed—dash “quotes” \x00ctrl\x07 zero​width",
    "I'M HERE 'S 'LL 'd 've 're 'm 't x'",
    "x<|endoftext|>y <|startoftext|>!hello! world!",
    " ".join(["portrait of a young girl with red hair"] * 12),
    "",
]


@pytest.fixture(scope="module", params=["tokenizer", "tokenizer_2"])
def pair(request, tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("tok") / request.param)
    write_clip_tokenizer(folder, learn_merges(TOKENIZER_CORPUS, 486),
                         pad="!" if request.param == "tokenizer_2"
                         else "<|endoftext|>")
    return HFCLIPTokenizer(folder), JaxTokenizer(folder)


@pytest.mark.parametrize("prompt", PROMPTS)
def test_ids_equal_transformers(pair, prompt):
    ours, ref = pair
    got, want = ours([prompt]), ref([prompt])
    assert got.dtype == want.dtype == np.int32 and got.shape == (1, 77)
    np.testing.assert_array_equal(got, want)
    assert ours.encode(prompt) == ref.encode(prompt)
    if prompt.strip():
        assert ours.encode_word(prompt) == ref.encode_word(prompt)
    ids = ours.encode(prompt)
    assert ours.decode(ids) == ref.decode(ids)
    assert [ours.decode([i]) for i in ids] == [ref.decode([i]) for i in ids]


def test_pad_and_truncation(pair):
    ours, ref = pair
    long = ours([PROMPTS[7]])[0]
    assert long[0] == ours.bos_id and long[-1] == ours.eos_id   # truncated
    short = ours(["a cat"])[0]
    eos = list(short).index(ours.eos_id)
    assert (short[eos + 1:] == ours.pad_id).all()
    assert ours.pad_id == ref.tk.pad_token_id
    # CLIP pools at the first EOS: the largest id in the vocabulary
    assert ours.eos_id == max(ours.encoder.values())


@pytest.mark.parametrize("word", ["man", "woman", "hat", "beach"])
def test_p2p_word_inds_agree(pair, word):
    ours, ref = pair
    text = PROMPTS[0].lower().rstrip(".")
    np.testing.assert_array_equal(p2p.get_word_inds(text, word, ours),
                                  jp2p.get_word_inds(text, word, ref))
