"""Pure-python canonical SMILES: writer + parser, no RDKit required (numpy
copy of ``geoldm_tpu/evalsuite/smiles.py``; the port keeps its own).

The no-RDKit fallback metrics (``evalsuite.rdkit_metrics``) name each valid
molecule by a canonical SMILES string: readable, portable and usable for
novelty checks against external SMILES lists. The reference delegates all of
this to RDKit (qm9/rdkit_functions.py:87-118).

Representation: molecules are (symbols, orders, charges) with explicit
atoms: hydrogens are real graph nodes (the bond inference produces them),
so the writer emits every atom bracketed (``[H][C]([H])([H])[H]``) and never
relies on implicit-H valence rules. The parser accepts the common subset of
standard SMILES: bare organic-subset atoms (implicit hydrogens become
explicit [H] nodes), bracket atoms with H-counts and formal charges, ring
closures (including %nn), and aromatic lowercase forms, which are kekulized
into alternating single/double bonds, so externally produced canonical
SMILES (e.g. RDKit's) can be re-canonicalized here and compared on equal
terms.

Canonicalization: Morgan/Weisfeiler-Lehman iterative refinement over
(element, charge, incident bond orders), with symmetry ties broken by
branching over the smallest tied class and taking the lexicographically
smallest emitted string (a branch budget bounds the cost). Isomorphic graphs
yield byte-identical SMILES.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Standard valences used to materialize implicit hydrogens when parsing
# bare organic-subset atoms (SMILES spec: B, C, N, O, P, S, halogens).
_ORGANIC_VALENCE = {
    "B": 3, "C": 4, "N": 3, "O": 2, "P": 3, "S": 2,
    "F": 1, "Cl": 1, "Br": 1, "I": 1,
}
_BOND_CHAR = {1: "", 2: "=", 3: "#"}
_CHAR_BOND = {"-": 1, "=": 2, "#": 3, ":": None}  # ":" handled as aromatic


class SmilesError(ValueError):
    """Raised for SMILES strings outside the supported subset."""


# ---------------------------------------------------------------------------
# Canonical ranking (Morgan / WL refinement with branch-and-min tie-breaks)
# ---------------------------------------------------------------------------


def _dense_ranks(vals: List) -> List[int]:
    order = {v: r for r, v in enumerate(sorted(set(vals)))}
    return [order[v] for v in vals]


def _refine(ranks: List[int], neigh: List[List[int]], orders: np.ndarray) -> List[int]:
    """Iterate (rank, sorted neighborhood signature) until the partition is
    stable. Refinement only ever splits classes, so it terminates in <= n
    rounds."""
    n = len(ranks)
    while True:
        sig = [
            (ranks[i], tuple(sorted((int(orders[i][j]), ranks[j]) for j in neigh[i])))
            for i in range(n)
        ]
        new = _dense_ranks(sig)
        if new == ranks:
            return ranks
        ranks = new


def _initial_ranks(symbols, charges, neigh, orders) -> List[int]:
    init = [
        (
            symbols[i],
            int(charges[i]),
            tuple(sorted(int(orders[i][j]) for j in neigh[i])),
        )
        for i in range(len(symbols))
    ]
    return _refine(_dense_ranks(init), neigh, orders)


def canonical_smiles(
    symbols: Sequence[str],
    sym_orders: np.ndarray,
    charges: Optional[Sequence[int]] = None,
    branch_budget: int = 64,
) -> str:
    """Permutation-invariant SMILES of one CONNECTED molecule graph.

    symbols: per-atom element strings; sym_orders: [N, N] symmetric integer
    bond orders (1/2/3); charges: per-atom formal charges (default 0).
    """
    n = len(symbols)
    if n == 0:
        return ""
    orders = np.asarray(sym_orders)
    charges = [0] * n if charges is None else [int(c) for c in charges]
    neigh = [sorted(int(j) for j in np.nonzero(orders[i])[0]) for i in range(n)]

    ranks = _initial_ranks(list(symbols), charges, neigh, orders)
    budget = [max(1, branch_budget)]
    best: List[Optional[str]] = [None]
    truncated = [False]

    def complete(ranks_: List[int]) -> None:
        if budget[0] <= 0:
            # A pending branch is being skipped: WHICH branches got
            # explored depends on input atom order, so the min over the
            # explored subset is no longer permutation-invariant.
            truncated[0] = True
            return
        counts: Dict[int, int] = {}
        for r in ranks_:
            counts[r] = counts.get(r, 0) + 1
        tied = sorted(r for r, c in counts.items() if c > 1)
        if not tied:
            budget[0] -= 1
            s = _emit(symbols, orders, charges, neigh, ranks_)
            if best[0] is None or s < best[0]:
                best[0] = s
            return
        # Individuate each member of the smallest tied class in turn and
        # re-refine; the minimum over branches is permutation-invariant.
        cls = [i for i in range(n) if ranks_[i] == tied[0]]
        # Degree-1 members hanging off the SAME atom are automorphic
        # (tied => same symbol/charge/bond order; swapping two such
        # leaves is a graph automorphism), so their branches emit
        # identical strings — keep one per parent. Dominant case:
        # explicit-H methyl/amino groups, which otherwise multiply the
        # leaf count by 3! per group (caffeine: 27x).
        seen_parents: set = set()
        pruned = []
        for i in cls:
            if len(neigh[i]) == 1:
                if neigh[i][0] in seen_parents:
                    continue
                seen_parents.add(neigh[i][0])
            pruned.append(i)
        for a in pruned:
            if budget[0] <= 0:
                truncated[0] = True
                return
            forked = [r * 2 for r in ranks_]
            forked[a] -= 1
            complete(_refine(_dense_ranks(forked), neigh, orders))

    complete(ranks)
    if truncated[0]:
        # Budget exhausted mid-tie-breaking (pathologically symmetric
        # graph). Fall back to a permutation-invariant WL graph key so
        # isomorphic inputs still map to one string — not valid SMILES,
        # but stable for uniqueness/novelty counting, and distinctively
        # marked so downstream parsers reject rather than misread it.
        return _wl_graph_key(list(symbols), orders, charges, ranks)
    assert best[0] is not None
    return best[0]


def _wl_graph_key(symbols, orders, charges, ranks) -> str:
    """Permutation-invariant graph key from the stable WL refinement:
    the sorted multiset of per-atom (rank, symbol, charge) plus the
    sorted multiset of (rank_lo, rank_hi, bond order) edges. Rank values
    are dense positions in a sorted order of invariant signatures, so
    both multisets are independent of input atom order."""
    import hashlib

    atoms = sorted(
        (ranks[i], symbols[i], int(charges[i])) for i in range(len(symbols))
    )
    ii, jj = np.nonzero(np.triu(orders, k=1))
    edges = sorted(
        (min(ranks[i], ranks[j]), max(ranks[i], ranks[j]), int(orders[i][j]))
        for i, j in zip(ii.tolist(), jj.tolist())
    )
    # 1-WL cannot separate some non-isomorphic regular graphs — exactly
    # the pathologically symmetric inputs that exhaust the budget. Fold
    # in the bond-order-weighted adjacency spectrum (permutation
    # invariant; separates most WL-equivalent pairs; cospectral+WL-
    # equivalent collisions remain possible but are far rarer).
    spec = np.linalg.eigvalsh(np.asarray(orders, dtype=np.float64))
    # + 0.0 folds -0.0 into +0.0 (repr differs; the sign of a zero
    # eigenvalue is permutation-dependent noise).
    spectrum = tuple((np.round(np.sort(spec), 6) + 0.0).tolist())
    digest = hashlib.sha1(
        repr((atoms, edges, spectrum)).encode()).hexdigest()[:20]
    return f"*WL:{digest}*"


def _atom_token(symbol: str, charge: int) -> str:
    if charge == 0:
        c = ""
    elif charge == 1:
        c = "+"
    elif charge == -1:
        c = "-"
    else:
        c = f"{charge:+d}"
    return f"[{symbol}{c}]"


def _ring_token(num: int) -> str:
    return str(num) if num < 10 else f"%{num:02d}"


def _emit(symbols, orders, charges, neigh, ranks) -> str:
    """Emit SMILES with a deterministic DFS (children in rank order).

    Two passes: the first discovers back edges (ring closures) along the
    exact traversal the second pass will take; the second writes tokens.
    The bond symbol of a ring bond is written at both endpoints (legal, and
    keeps single-pass parsing simple)."""
    n = len(symbols)
    root = min(range(n), key=lambda i: (ranks[i], i))

    # Pass 1: spanning tree + ring (non-tree) edges. Children are claimed
    # in rank order as each node is expanded; pass 2 follows the same
    # parent[] array, so the two passes agree on the tree by construction.
    parent = [-2] * n
    back_edges: List[Tuple[int, int]] = []
    order_key = lambda j: ranks[j]
    stack = [(root, -1)]
    parent[root] = -1
    while stack:
        i, par = stack.pop()
        children = []
        for j in sorted(neigh[i], key=order_key):
            if j == par:
                continue
            if parent[j] == -2:
                parent[j] = i
                children.append(j)
            else:
                e = (min(i, j), max(i, j))
                if all((min(a, b), max(a, b)) != e for a, b in back_edges):
                    back_edges.append((i, j))
        for j in reversed(children):
            stack.append((j, i))

    ring_of: Dict[Tuple[int, int], int] = {}
    for k, (i, j) in enumerate(back_edges):
        ring_of[(min(i, j), max(i, j))] = k + 1

    out: List[str] = []

    def rec(i: int, par: int) -> None:
        out.append(_atom_token(symbols[i], charges[i]))
        ring_here = []
        tree_children = []
        for j in sorted(neigh[i], key=order_key):
            if j == par:
                continue
            e = (min(i, j), max(i, j))
            if e in ring_of and parent[j] != i and parent[i] != j:
                ring_here.append((j, e))
            elif parent[j] == i:
                tree_children.append(j)
        for j, e in ring_here:
            out.append(_BOND_CHAR[int(orders[i][j])] + _ring_token(ring_of[e]))
        for idx, j in enumerate(tree_children):
            bond = _BOND_CHAR[int(orders[i][j])]
            if idx < len(tree_children) - 1:
                out.append("(" + bond)
                rec(j, i)
                out.append(")")
            else:
                out.append(bond)
                rec(j, i)

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 100))
    try:
        rec(root, -1)
    finally:
        sys.setrecursionlimit(old_limit)
    return "".join(out)


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

_TWO_LETTER = ("Cl", "Br")
_AROMATIC = {"b": "B", "c": "C", "n": "N", "o": "O", "p": "P", "s": "S"}


def parse_smiles(s: str) -> Tuple[List[str], np.ndarray, List[int]]:
    """Parse a SMILES string -> (symbols, sym_orders [N,N], charges).

    Supported subset: bracket atoms ``[Xq]``/``[XHn]``/``[X+2]``, bare
    organic-subset atoms (implicit hydrogens materialized as explicit [H]
    nodes), aromatic lowercase atoms (kekulized — see _kekulize), bonds
    ``- = # :``, branches, ring closures incl. ``%nn``. Unsupported
    constructs (isotopes, stereo ``/ \\ @``, wildcards, dots) raise
    SmilesError — callers treat that as "not comparable", never as a
    silent wrong answer."""
    symbols: List[str] = []
    charges: List[int] = []
    aromatic_atom: List[bool] = []
    implicit_h: List[Optional[int]] = []  # None = bracket atom (explicit count)
    bonds: List[Tuple[int, int, Optional[int], bool]] = []  # i, j, order, aromatic

    prev = -1
    pending_bond: Optional[str] = None
    stack: List[int] = []
    open_rings: Dict[int, Tuple[int, Optional[str]]] = {}

    def add_atom(sym, charge, arom, h_count):
        nonlocal prev, pending_bond
        idx = len(symbols)
        symbols.append(sym)
        charges.append(charge)
        aromatic_atom.append(arom)
        implicit_h.append(h_count)
        if prev >= 0:
            _add_bond(prev, idx, pending_bond, arom and aromatic_atom[prev])
        pending_bond = None
        prev = idx

    def _add_bond(i, j, bond_char, both_aromatic):
        if bond_char is None:
            if both_aromatic:
                bonds.append((i, j, None, True))
            else:
                bonds.append((i, j, 1, False))
        elif bond_char == ":":
            bonds.append((i, j, None, True))
        else:
            bonds.append((i, j, _CHAR_BOND[bond_char], False))

    i = 0
    while i < len(s):
        ch = s[i]
        if ch == "[":
            end = s.find("]", i)
            if end < 0:
                raise SmilesError(f"unclosed bracket atom in {s!r}")
            body = s[i + 1 : end]
            sym, charge, arom, h_count = _parse_bracket(body, s)
            add_atom(sym, charge, arom, h_count)
            i = end + 1
        elif ch in "-=#:":
            if pending_bond is not None:
                raise SmilesError(f"double bond symbol at {i} in {s!r}")
            pending_bond = ch
            i += 1
        elif ch == "(":
            if prev < 0:
                raise SmilesError(f"branch before any atom in {s!r}")
            stack.append(prev)
            i += 1
        elif ch == ")":
            if not stack:
                raise SmilesError(f"unbalanced ')' in {s!r}")
            prev = stack.pop()
            i += 1
        elif ch.isdigit() or ch == "%":
            if ch == "%":
                if i + 2 >= len(s) or not s[i + 1 : i + 3].isdigit():
                    raise SmilesError(f"bad %nn ring closure in {s!r}")
                num = int(s[i + 1 : i + 3])
                i += 3
            else:
                num = int(ch)
                i += 1
            if prev < 0:
                raise SmilesError(f"ring closure before any atom in {s!r}")
            if num in open_rings:
                j, open_char = open_rings.pop(num)
                bond_char = pending_bond or open_char
                if (pending_bond and open_char and pending_bond != open_char):
                    raise SmilesError(f"conflicting ring bond {num} in {s!r}")
                _add_bond(j, prev, bond_char,
                          aromatic_atom[j] and aromatic_atom[prev])
                pending_bond = None
            else:
                open_rings[num] = (prev, pending_bond)
                pending_bond = None
        elif ch.isalpha():
            if s[i : i + 2] in _TWO_LETTER:
                add_atom(s[i : i + 2], 0, False, -1)
                i += 2
            elif ch in _AROMATIC:
                add_atom(_AROMATIC[ch], 0, True, -1)
                i += 1
            elif ch.isupper() and ch in _ORGANIC_VALENCE:
                add_atom(ch, 0, False, -1)
                i += 1
            else:
                raise SmilesError(f"unsupported atom {ch!r} in {s!r}")
        elif ch == ".":
            raise SmilesError(f"multi-fragment SMILES unsupported: {s!r}")
        elif ch in "/\\@":
            raise SmilesError(f"stereo SMILES unsupported: {s!r}")
        else:
            raise SmilesError(f"unsupported character {ch!r} in {s!r}")

    if open_rings:
        raise SmilesError(f"unclosed ring bond(s) {sorted(open_rings)} in {s!r}")
    if stack:
        raise SmilesError(f"unclosed branch in {s!r}")

    return _materialize(symbols, charges, aromatic_atom, implicit_h, bonds, s)


def _parse_bracket(body: str, full: str):
    """[symbol(H count)(charge)] — isotopes/stereo/class are unsupported."""
    k = 0
    if k < len(body) and body[k].isdigit():
        raise SmilesError(f"isotope SMILES unsupported: {full!r}")
    arom = False
    if body[k : k + 2] in _TWO_LETTER:
        sym = body[k : k + 2]
        k += 2
    elif body[k : k + 1] in _AROMATIC:
        sym = _AROMATIC[body[k]]
        arom = True
        k += 1
    elif body[k : k + 1].isupper():
        sym = body[k]
        if k + 1 < len(body) and body[k + 1].islower() and sym + body[k + 1] not in ("H",):
            two = body[k : k + 2]
            sym, k = two, k + 2
        else:
            k += 1
    else:
        raise SmilesError(f"bad bracket atom [{body}] in {full!r}")
    h_count = 0
    if k < len(body) and body[k] == "H" and sym != "H":
        k += 1
        h_count = 1
        if k < len(body) and body[k].isdigit():
            h_count = int(body[k])
            k += 1
    charge = 0
    if k < len(body) and body[k] in "+-":
        sign = 1 if body[k] == "+" else -1
        k += 1
        if k < len(body) and body[k].isdigit():
            charge = sign * int(body[k])
            k += 1
        else:
            mag = 1
            while k < len(body) and body[k] == body[k - 1]:
                mag += 1
                k += 1
            charge = sign * mag
    if k != len(body):
        raise SmilesError(f"unsupported bracket content [{body}] in {full!r}")
    return sym, charge, arom, h_count


def _materialize(symbols, charges, aromatic_atom, implicit_h, bonds, full):
    """Resolve aromatic bonds (kekulize), add implicit hydrogens as explicit
    [H] atoms, and build the dense symmetric order matrix."""
    n0 = len(symbols)
    fixed = [(i, j, o) for (i, j, o, ar) in bonds if not ar]
    arom_edges = [(i, j) for (i, j, o, ar) in bonds if ar]
    kek = _kekulize(n0, symbols, charges, implicit_h, fixed, arom_edges, full)
    all_bonds = fixed + kek

    # Implicit H for bare organic atoms: standard valence - explicit order
    # sum - |charge adjustment| (charges only appear on bracket atoms, which
    # carry their own H count, so bare atoms are neutral here).
    order_sum = [0] * n0
    for i, j, o in all_bonds:
        order_sum[i] += o
        order_sum[j] += o
    symbols = list(symbols)
    charges = list(charges)
    for a in range(n0):
        if implicit_h[a] == -1:  # bare atom: derive from valence
            val = _ORGANIC_VALENCE[symbols[a]]
            # Aromatic N with no H spec (pyridine-type) already consistent;
            # pyrrole-type must be written [nH] per the SMILES spec.
            h = max(0, val - order_sum[a])
        else:
            h = implicit_h[a] or 0
        for _ in range(h):
            symbols.append("H")
            charges.append(0)
            all_bonds.append((a, len(symbols) - 1, 1))

    n = len(symbols)
    orders = np.zeros((n, n), dtype=np.int64)
    for i, j, o in all_bonds:
        if orders[i, j]:
            raise SmilesError(f"duplicate bond {i}-{j} in {full!r}")
        orders[i, j] = orders[j, i] = o
    return symbols, orders, charges


def _kekulize(n, symbols, charges, implicit_h, fixed, arom_edges, full):
    """Assign alternating single/double orders to aromatic bonds.

    Each aromatic atom needs (standard valence − non-aromatic order sum −
    hydrogens − aromatic degree) in {0, 1} extra order: 1 means the atom
    must receive exactly one double aromatic bond, 0 means all its aromatic
    bonds are single (pyrrole-type N/O contribute a lone pair). Finding the
    double bonds is a perfect matching on the 'needy' subgraph, solved by
    backtracking (molecular rings are tiny)."""
    if not arom_edges:
        return []
    ar_neigh: Dict[int, List[int]] = {}
    ar_deg = [0] * n
    for i, j in arom_edges:
        ar_neigh.setdefault(i, []).append(j)
        ar_neigh.setdefault(j, []).append(i)
        ar_deg[i] += 1
        ar_deg[j] += 1
    fixed_sum = [0] * n
    for i, j, o in fixed:
        fixed_sum[i] += o
        fixed_sum[j] += o
    needs = {}
    for a in ar_neigh:
        val = _ORGANIC_VALENCE.get(symbols[a])
        if val is None:
            raise SmilesError(f"aromatic {symbols[a]} unsupported in {full!r}")
        val += charges[a] if symbols[a] in ("N", "P") else -abs(charges[a])
        h = implicit_h[a]
        if h == -1:
            # Bare aromatic atom: spec gives it implicit H only if a free
            # valence remains AFTER aromatic bonds; for C that is 1 when
            # ring degree is 2. N/O/S bare aromatic atoms get none.
            h = 1 if symbols[a] == "C" and ar_deg[a] == 2 and fixed_sum[a] == 0 else 0
        need = val - fixed_sum[a] - (h or 0) - ar_deg[a]
        if need not in (0, 1):
            raise SmilesError(
                f"cannot kekulize atom {a} ({symbols[a]}) in {full!r}")
        needs[a] = need

    edges = [tuple(e) for e in arom_edges]
    matched: Dict[int, int] = {}
    # Pruning: once the last edge touching a still-unmatched needy atom has
    # been skipped, no completion exists — cut that branch immediately.
    # This keeps fused aromatic systems (many edges) effectively linear.
    last_edge: Dict[int, int] = {}
    for idx, (i, j) in enumerate(edges):
        last_edge[i] = idx
        last_edge[j] = idx

    def bt(k: int) -> bool:
        if k == len(edges):
            return all(needs[a] == 0 or a in matched for a in needs)
        i, j = edges[k]
        if needs[i] and needs[j] and i not in matched and j not in matched:
            matched[i] = j
            matched[j] = i
            if bt(k + 1):
                return True
            del matched[i], matched[j]
        for a in (i, j):
            if needs[a] and a not in matched and last_edge[a] == k:
                return False
        return bt(k + 1)

    if not bt(0):
        raise SmilesError(f"kekulization failed for {full!r}")
    out = []
    for i, j in edges:
        double = matched.get(i) == j
        out.append((i, j, 2 if double else 1))
    return out


def recanonicalize(s: str) -> str:
    """Parse an external SMILES and re-emit it in this module's canonical
    form (explicit atoms, bracket notation) — the bridge that makes
    externally supplied lists comparable to fallback-generated identities.
    Raises SmilesError for unsupported constructs."""
    symbols, orders, charges = parse_smiles(s)
    return canonical_smiles(symbols, orders, charges)
