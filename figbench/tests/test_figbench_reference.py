"""The plain reference against a join materialized row by row in numpy, and
the compared numbers against numpy's own QR, SVD, PCA and least squares of
that matrix."""

import copy
import json
import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from figbench.data import make_tables  # noqa: E402
from figbench.manifest import Manifest  # noqa: E402
from figbench.reference.checks import check_answer, perm  # noqa: E402
from figbench.reference.join import Join  # noqa: E402

MANIFEST = Manifest()
#: The many-to-many schema of the port's ``yelp_like``, a test fixture (not a
#: configuration of the benchmark).
MANY = json.loads((pathlib.Path(__file__).with_name("many_to_many.json"))
                  .read_text())


def _config(name):
    return copy.deepcopy(MANY if name == "many_to_many"
                         else MANIFEST.config(name))


SMALL = {"many_to_many": dict(review_rows=120, users=12, businesses=6,
                              width=2),
         "favorita": dict(sales_rows=150, stores=3, items=5, days=4)}


def _tables(name, seed=5):
    cfg = dict(_config(name), **SMALL[name])
    return cfg, make_tables(cfg, seed)


def _materialize(tables, columns):
    """The natural join by nested loops: partial rows extended one relation
    at a time, kept where they agree on every shared key attribute."""
    names = list(dict.fromkeys(c.split(".")[0] for c in columns))
    partial = [({}, [])]
    for n in names:
        t, grown = tables[n], []
        for keys, parts in partial:
            for i in range(t.rows):
                row = {a: int(k[i]) for a, k in t.keys.items()}
                if all(keys.get(a, v) == v for a, v in row.items()):
                    grown.append(({**keys, **row}, parts + [t.data[i]]))
        partial = grown
    return np.asarray([np.concatenate(parts) for _, parts in partial])


@pytest.mark.parametrize("name", ["many_to_many", "favorita"])
def test_gram_of_the_materialized_join(name):
    cfg, tables = _tables(name)
    join = Join(tables, cfg["root"], cfg["edges"])
    a = _materialize(tables, join.columns)
    (g, s, n), = join.gram([{k: t.data for k, t in tables.items()}],
                           block_rows=7)
    assert n == a.shape[0] == join.rows
    np.testing.assert_allclose(g, a.T @ a, rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(s, a.sum(0), rtol=1e-12, atol=1e-10)


def test_every_number_reads_rounding_on_numpys_answers_and_more_when_wrong():
    cfg, tables = _tables("many_to_many")
    join = Join(tables, cfg["root"], cfg["edges"])
    ref = join.gram([{k: t.data for k, t in tables.items()}])[0]
    a = _materialize(tables, join.columns)
    rng = np.random.default_rng(0)
    shuffle = rng.permutation(a.shape[1])  # the answer's own column order
    names = [join.columns[j] for j in shuffle]
    b = a[:, shuffle]
    r = np.linalg.qr(b, mode="r")
    r = r * np.sign(np.diag(r))[:, None]
    _, s, vt = np.linalg.svd(b, full_matrices=False)
    mu = b.mean(0)
    cov = (b - mu).T @ (b - mu) / (b.shape[0] - 1)
    var, comps = np.linalg.eigh(cov)
    var, comps = var[::-1][:3], comps[:, ::-1][:, :3].T
    label = cfg["label"]
    li = names.index(label)
    feats = [j for j in range(len(names)) if j != li]
    beta = np.linalg.lstsq(b[:, feats], b[:, li], rcond=None)[0]
    answers = {"qr": r, "svd": (s, -vt), "pca": (comps, var, mu),
               "lsq": beta}
    for kind, answer in answers.items():
        got = check_answer(kind, answer, names, join.columns, ref, k=3,
                           label=label)
        assert max(got.values()) < 1e-9, (kind, got)
    wrong = {"qr": r * (1 + 1e-6 * np.triu(np.ones_like(r))),
             "svd": (s * (1 + 1e-6), vt),
             "pca": (comps, var, mu + 1e-6),
             "lsq": beta * (1 + 1e-6)}
    for kind, answer in wrong.items():
        got = check_answer(kind, answer, names, join.columns, ref, k=3,
                           label=label)
        assert max(got.values()) > 1e-8, (kind, got)


def test_columns_are_matched_by_name():
    assert list(perm(["b", "c", "a"], ["a", "b", "c"])) == [2, 0, 1]
    with pytest.raises(ValueError):
        perm(["a", "b"], ["a", "c"])
