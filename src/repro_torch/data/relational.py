"""Relational dataset generators shaped like the paper's benchmarks (§8).

Scaled-down analogues of the three real datasets (Table 1):

  * ``retailer_like``  — snowflake: fact Inventory(location, item, date) with
    dimension chains Location->Census and Item, Weather (key-fkey).
  * ``favorita_like``  — star: fact Sales with dimensions Stores, Items,
    Transactions, Oil, Holidays (key-fkey).
  * ``yelp_like``      — star with *many-to-many* joins: Review(user, business)
    against User and Business x (Category, CheckIn, Hours): join >> input.
  * ``cartesian``      — two relations, join == Cartesian product (§1.1 and
    the Fig-5 / Tab-3 synthetic experiments).
  * ``accuracy_db``    — the reverse-engineering construction of Exp 4: a
    database whose join-QR has a *known ground-truth* R block.

Sizes are parameterized so benchmarks can sweep "percentage of dataset"
exactly like Fig 4.

Every generator returns a ready `JoinTree`. The generators are copies of
the JAX package's, drawing from numpy ``default_rng(seed)`` in the same
order, so both packages see identical tables. The plan-level compute entry
point is `repro_torch.figaro.Session`::

    from repro_torch import figaro
    from repro_torch.data.relational import retailer_like

    r = figaro.Session(device="cuda").qr(retailer_like(scale=1000))
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.join_tree import JoinTree
from repro_torch.core.relation import Database, full_reduce

__all__ = ["retailer_like", "favorita_like", "yelp_like", "cartesian",
           "accuracy_db"]


def _rand_data(rng, m, n):
    return rng.uniform(-3.0, 3.0, size=(m, n))  # paper's U[-3, 3)


def retailer_like(scale: int = 1000, *, cols: int = 4, seed: int = 0,
                  root: str = "good") -> JoinTree:
    """Snowflake; `root` in {good, bad} mirrors Table 2's join-tree choice.

    ``root="auto"`` needs the cost-based planner, which the port does not
    have yet; it raises `NotImplementedError` until the planner is ported.
    """
    if root == "auto":
        raise NotImplementedError(
            "retailer_like(root='auto') needs the join-tree planner, which "
            "is not ported yet (ROADMAP.md queue A, item A8); pass "
            "root='good' or root='bad'")
    rng = np.random.default_rng(seed)
    n_loc, n_item, n_date = max(scale // 50, 4), max(scale // 20, 6), \
        max(scale // 10, 8)
    m_fact = scale * 4
    tables = {
        "Inventory": ({"loc": rng.integers(0, n_loc, m_fact),
                       "item": rng.integers(0, n_item, m_fact),
                       "date": rng.integers(0, n_date, m_fact)},
                      _rand_data(rng, m_fact, 1), ["inv0"]),
        "Location": ({"loc": np.arange(n_loc),
                      "zip": rng.integers(0, max(n_loc // 2, 2), n_loc)},
                     _rand_data(rng, n_loc, cols), [f"l{i}" for i in range(cols)]),
        "Census": ({"zip": np.arange(max(n_loc // 2, 2))},
                   _rand_data(rng, max(n_loc // 2, 2), cols),
                   [f"c{i}" for i in range(cols)]),
        "Item": ({"item": np.arange(n_item)},
                 _rand_data(rng, n_item, cols), [f"i{i}" for i in range(cols)]),
        "Weather": ({"loc": np.repeat(np.arange(n_loc), n_date // 2 or 1),
                     "date": np.tile(np.arange(n_date // 2 or 1), n_loc)},
                    _rand_data(rng, n_loc * (n_date // 2 or 1), cols),
                    [f"w{i}" for i in range(cols)]),
    }
    db = Database.from_arrays(tables)
    if root == "good":
        edges = [("Inventory", "Item"), ("Inventory", "Weather"),
                 ("Inventory", "Location"), ("Location", "Census")]
        rootn = "Inventory"
    else:  # bad: fact table deep in the tree
        edges = [("Location", "Census"), ("Location", "Inventory"),
                 ("Inventory", "Item"), ("Inventory", "Weather")]
        rootn = "Location"
    db = full_reduce(db, edges)
    return JoinTree.from_edges(db, rootn, edges)


def favorita_like(scale: int = 1000, *, cols: int = 3, seed: int = 1) -> JoinTree:
    rng = np.random.default_rng(seed)
    n_store, n_item, n_date = max(scale // 40, 4), max(scale // 20, 5), \
        max(scale // 10, 8)
    m = scale * 4
    tables = {
        "Sales": ({"store": rng.integers(0, n_store, m),
                   "item": rng.integers(0, n_item, m),
                   "date": rng.integers(0, n_date, m)},
                  _rand_data(rng, m, 1), ["units"]),
        "Stores": ({"store": np.arange(n_store)},
                   _rand_data(rng, n_store, cols), [f"s{i}" for i in range(cols)]),
        "Items": ({"item": np.arange(n_item)},
                  _rand_data(rng, n_item, cols), [f"i{i}" for i in range(cols)]),
        "Transactions": ({"store": np.repeat(np.arange(n_store), n_date),
                          "date": np.tile(np.arange(n_date), n_store)},
                         _rand_data(rng, n_store * n_date, 1), ["txn"]),
        "Oil": ({"date": np.arange(n_date)},
                _rand_data(rng, n_date, 1), ["oil"]),
        "Holidays": ({"date": np.arange(n_date)},
                     _rand_data(rng, n_date, 1), ["hol"]),
    }
    db = Database.from_arrays(tables)
    edges = [("Sales", "Stores"), ("Sales", "Items"),
             ("Sales", "Transactions"), ("Transactions", "Oil"),
             ("Oil", "Holidays")]
    # Oil->Holidays keeps the tree a snowflake over `date` without making
    # Sales the only hub (both share `date`; join-tree property holds).
    db = full_reduce(db, edges)
    return JoinTree.from_edges(db, "Sales", edges)


def yelp_like(scale: int = 300, *, cols: int = 3, seed: int = 2) -> JoinTree:
    """Many-to-many: |join| >> |input| (the paper's best-case regime).

    At ``scale=4_000_000, cols=16`` Review has 8 M rows (the size of the
    Yelp dataset's review table) and the join has N = 35 data columns.
    """
    rng = np.random.default_rng(seed)
    n_user, n_biz = max(scale // 10, 5), max(scale // 15, 4)
    m_rev = scale * 2
    tables = {
        "Review": ({"user": rng.integers(0, n_user, m_rev),
                    "biz": rng.integers(0, n_biz, m_rev)},
                   _rand_data(rng, m_rev, 1), ["stars"]),
        "User": ({"user": np.arange(n_user)},
                 _rand_data(rng, n_user, cols), [f"u{i}" for i in range(cols)]),
        "Business": ({"biz": np.arange(n_biz)},
                     _rand_data(rng, n_biz, cols), [f"b{i}" for i in range(cols)]),
        # many-to-many: several categories / checkins per business
        "Category": ({"biz": rng.integers(0, n_biz, n_biz * 5)},
                     _rand_data(rng, n_biz * 5, 1), ["cat"]),
        "CheckIn": ({"biz": rng.integers(0, n_biz, n_biz * 7)},
                    _rand_data(rng, n_biz * 7, 1), ["chk"]),
    }
    db = Database.from_arrays(tables)
    edges = [("Review", "User"), ("Review", "Business"),
             ("Business", "Category"), ("Business", "CheckIn")]
    db = full_reduce(db, edges)
    return JoinTree.from_edges(db, "Review", edges)


def cartesian(p: int, q: int, *, n1: int = 2, n2: int = 2,
              seed: int = 3) -> JoinTree:
    rng = np.random.default_rng(seed)
    tables = {
        "S": ({}, _rand_data(rng, p, n1), [f"s{i}" for i in range(n1)]),
        "T": ({}, _rand_data(rng, q, n2), [f"t{i}" for i in range(n2)]),
    }
    db = Database.from_arrays(tables)
    return JoinTree.from_edges(db, "S", [("S", "T")])


def accuracy_db(p: int, q: int, n: int, *, seed: int = 4
                ) -> tuple[JoinTree, np.ndarray]:
    """Exp-4 construction: returns (tree, R_fixed ground truth).

    T := Q_T·R_fixed/√p for a random orthonormal Q_T and a chosen
    upper-triangular R_fixed; S gets zero column sums, so the exact R of the
    Cartesian product S×T is block-diagonal with the T-block equal to
    √p·(R_fixed/√p) = R_fixed — the arbitrary ground truth of Table 3.
    """
    rng = np.random.default_rng(seed)
    r_fixed = np.triu(rng.normal(size=(n, n)))
    r_fixed[np.diag_indices(n)] = np.abs(r_fixed[np.diag_indices(n)]) + 0.5
    qmat, _ = np.linalg.qr(rng.normal(size=(q, n)))
    t_mat = qmat @ (r_fixed / np.sqrt(p))
    s_mat = rng.normal(size=(p, n))
    s_mat -= s_mat.mean(axis=0, keepdims=True)  # zero column sums
    tables = {
        "S": ({}, s_mat, [f"s{i}" for i in range(n)]),
        "T": ({}, t_mat, [f"t{i}" for i in range(n)]),
    }
    db = Database.from_arrays(tables)
    tree = JoinTree.from_edges(db, "S", [("S", "T")])
    return tree, r_fixed
