"""The generator of planes: a seed gives the same planes, and the planes
have the configuration's statistics and the port's layout."""
import numpy as np
import pytest
import torch

from qabench.harness import planes as gen
from qabench.harness import spec
from qabench.reference import rdf as R

N = 200_000


@pytest.fixture(scope="module")
def config():
    return dict(spec.load_cell("bsbm_20gb.report_all").config, triples=N)


@pytest.fixture(scope="module")
def rows(config):
    return gen.make_planes(config, 2**31 + 77, "cpu", block_rows=1 << 16)


def test_same_seed_same_planes(config, rows):
    again = gen.make_planes(config, 2**31 + 77, "cpu", block_rows=1 << 16)
    other = gen.make_planes(config, 2**31 + 78, "cpu", block_rows=1 << 16)
    assert rows.dtype == torch.int32 and rows.shape == (N, R.N_PLANES)
    assert torch.equal(rows, again)
    assert not torch.equal(rows, other)


def test_shares_match_the_profile(config, rows):
    prof = config["profile"]
    x = rows.numpy()
    o, p, s = x[:, R.O_FLAGS], x[:, R.P_FLAGS], x[:, R.S_FLAGS]
    lit = (o & R.KIND_LITERAL) != 0
    typed = lit & ((o & R.HAS_DATATYPE) != 0)
    iri_o = (o & R.KIND_IRI) != 0

    def near(share, want, n):
        # five standard errors of a binomial share
        assert abs(share - want) <= 5 * np.sqrt(want * (1 - want) / n) \
            + 1e-9, (share, want)
    near(lit.mean(), prof["literal_obj"], N)
    near(((o & R.KIND_BLANK) != 0).mean(), prof["blank_obj"], N)
    near(typed.sum() / lit.sum(), prof["typed_literal"], lit.sum())
    near((typed & ((o & R.LEXICAL_OK) == 0)).sum() / typed.sum(),
         prof["malformed_literal"], typed.sum())
    near(((s & R.INTERNAL) == 0).mean(), prof["external_subj"], N)
    near((iri_o & ((o & R.INTERNAL) == 0)).sum() / iri_o.sum(),
         prof["external_obj"], iri_o.sum())
    near(((p & R.IS_LABEL_PRED) != 0).mean(), prof["label_triple"], N)
    near(((p & R.IS_SAMEAS) != 0).mean(), prof["sameas"], N)
    near(((p & R.IS_RDFTYPE) != 0).mean(), prof["rdftype"], N)
    near((x[:, R.S_LEN] > 80).mean(), prof["long_uri"], N)
    assert ((s & R.VALID) != 0).all() and ((o & R.VALID) != 0).all()
    n_subj = N // prof["subject_pool_divisor"]
    assert x[:, R.S].min() == 0 and x[:, R.S].max() < n_subj
    assert (x[:, R.S] == 0).mean() > 0.2          # Zipf(1.3)'s head
    pids = np.unique(x[:, R.P])
    assert pids.min() >= n_subj and pids.max() < n_subj + 64


def test_layout_is_the_ports(rows):
    from repro_torch.rdf import vocab
    from repro_torch.rdf import triple_tensor as tt
    for name, bit in vocab.FLAG_NAMES.items():
        assert getattr(R, name) == bit
    assert (R.S, R.P, R.O, R.S_FLAGS, R.P_FLAGS, R.O_FLAGS, R.S_LEN,
            R.P_LEN, R.O_LEN, R.O_DT, R.S_HASH, R.P_HASH, R.O_HASH,
            R.N_PLANES) == (tt.COL_S, tt.COL_P, tt.COL_O, tt.COL_S_FLAGS,
                            tt.COL_P_FLAGS, tt.COL_O_FLAGS, tt.COL_S_LEN,
                            tt.COL_P_LEN, tt.COL_O_LEN, tt.COL_O_DT,
                            tt.COL_S_HASH, tt.COL_P_HASH, tt.COL_O_HASH,
                            tt.N_PLANES)
    assert (R.DT_NONE, R.DT_STRING, R.DT_LANGSTRING, R.DT_OTHER) == (
        vocab.DT_NONE, vocab.DT_STRING, vocab.DT_LANGSTRING, vocab.DT_OTHER)
    x = rows.numpy()
    for ids, hashes in ((R.S, R.S_HASH), (R.P, R.P_HASH), (R.O, R.O_HASH)):
        assert np.array_equal(tt.synthetic_term_hash(x[:, ids]),
                              x[:, hashes])


def test_zipf_matches_numpy_law():
    g = torch.Generator().manual_seed(5)
    ours = gen.zipf(g, 400_000, 1.3, 10**9, "cpu").numpy()
    theirs = np.random.default_rng(5).zipf(1.3, 400_000)
    for k in (1, 2, 3, 10):
        a, b = (ours == k).mean(), (theirs == k).mean()
        assert abs(a - b) < 5 * np.sqrt(b * (1 - b) / 400_000) * 1.5, k
