"""Problem serialization for offline benchmarking.

Counterpart of ``epsilon_tpu/utils/serialization.py``, in the same format
(each package reads what the other wrote): persist a compiled prox-affine
problem and its constant data as an npz file beside a JSON manifest, so
instances can be re-solved without regenerating.  Host numpy and scipy
only.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import scipy.sparse as sp

from ..ir import (AffineOperator, Cone, ConeConstraint, ProxFunctionSpec,
                  ProxKind, ProxProblem, ProxTerm)
from ..ops import linop
from ..ops.block import BlockMatrix, BlockVector


def _op_manifest(op: linop.LinOp, arrays: Dict[str, np.ndarray], key: str):
    if isinstance(op, linop.ScalarOp):
        return {"kind": "scalar", "alpha": op.alpha, "n": op.n}
    if isinstance(op, linop.DiagonalOp):
        arrays[key] = op.d
        return {"kind": "diagonal", "data": key}
    if isinstance(op, linop.KronOp):
        a = _op_manifest(op.A, arrays, key + ".A")
        b = _op_manifest(op.B, arrays, key + ".B")
        return {"kind": "kron", "A": a, "B": b}
    if isinstance(op, linop.SparseOp):
        csr = op.as_sparse()
        arrays[key + ".data"] = csr.data
        arrays[key + ".indices"] = csr.indices
        arrays[key + ".indptr"] = csr.indptr
        return {"kind": "sparse", "key": key, "shape": list(op.shape)}
    arrays[key] = op.as_dense()
    return {"kind": "dense", "data": key}


def _op_restore(man, arrays) -> linop.LinOp:
    kind = man["kind"]
    if kind == "scalar":
        return linop.scalar(man["alpha"], man["n"])
    if kind == "diagonal":
        return linop.diagonal(arrays[man["data"]])
    if kind == "kron":
        return linop.KronOp(_op_restore(man["A"], arrays),
                            _op_restore(man["B"], arrays))
    if kind == "sparse":
        key = man["key"]
        m, n = man["shape"]
        return linop.sparse(sp.csr_matrix(
            (arrays[key + ".data"], arrays[key + ".indices"],
             arrays[key + ".indptr"]), shape=(m, n)))
    return linop.dense(arrays[man["data"]])


def _affop_manifest(affop: AffineOperator, arrays, prefix):
    blocks = []
    for i, ((r, c), op) in enumerate(sorted(affop.A.blocks.items())):
        blocks.append({"row": r, "col": c,
                       "op": _op_manifest(op, arrays, f"{prefix}.A{i}")})
    offsets = []
    for r, v in sorted(affop.b.items()):
        key = f"{prefix}.b.{r}"
        arrays[key] = np.asarray(v)
        offsets.append({"row": r, "data": key})
    return {"blocks": blocks, "offsets": offsets}


def _affop_restore(man, arrays) -> AffineOperator:
    A = BlockMatrix()
    for b in man["blocks"]:
        A.insert(b["row"], b["col"], _op_restore(b["op"], arrays))
    bvec = BlockVector({o["row"]: np.asarray(arrays[o["data"]])
                        for o in man["offsets"]})
    return AffineOperator(A, bvec)


def write_problem(problem: ProxProblem, path: str):
    """Persist to <path>.json + <path>.npz."""
    arrays: Dict[str, np.ndarray] = {}
    man = {"terms": [], "constraints": [],
           "var_dims": problem.var_dims,
           "var_shapes": {k: list(v) for k, v in problem.var_shapes.items()}}
    for i, t in enumerate(problem.terms):
        szp = None
        if t.spec.scaled_zone_params is not None:
            szp = {}
            for k, v in t.spec.scaled_zone_params.items():
                if isinstance(v, np.ndarray):
                    arrays[f"t{i}.szp.{k}"] = v
                    szp[k] = {"data": f"t{i}.szp.{k}"}
                else:
                    szp[k] = float(v)
        man["terms"].append({
            "kind": t.spec.kind.value, "epigraph": t.spec.epigraph,
            "alpha": t.spec.alpha, "k": t.spec.k, "axis": t.spec.axis,
            "arg_sizes": [list(s) for s in t.spec.arg_sizes],
            "scaled_zone_params": szp,
            "H": _affop_manifest(t.H, arrays, f"t{i}")})
    for i, c in enumerate(problem.constraints):
        man["constraints"].append({
            "cone": c.cone.value,
            "op": _affop_manifest(c.op, arrays, f"c{i}")})
    with open(path + ".json", "w") as f:
        json.dump(man, f)
    np.savez_compressed(path + ".npz", **arrays)


def read_problem(path: str) -> ProxProblem:
    with open(path + ".json") as f:
        man = json.load(f)
    arrays = dict(np.load(path + ".npz"))
    terms = []
    for tm in man["terms"]:
        szp = None
        if tm["scaled_zone_params"] is not None:
            szp = {k: (arrays[v["data"]] if isinstance(v, dict) else v)
                   for k, v in tm["scaled_zone_params"].items()}
        spec = ProxFunctionSpec(
            kind=ProxKind(tm["kind"]), epigraph=tm["epigraph"],
            alpha=tm["alpha"], k=tm["k"], axis=tm["axis"],
            arg_sizes=[tuple(s) for s in tm["arg_sizes"]],
            scaled_zone_params=szp)
        terms.append(ProxTerm(spec=spec, H=_affop_restore(tm["H"], arrays)))
    constraints = [
        ConeConstraint(cone=Cone(cm["cone"]),
                       op=_affop_restore(cm["op"], arrays))
        for cm in man["constraints"]]
    return ProxProblem(terms=terms, constraints=constraints,
                       var_dims=man["var_dims"],
                       var_shapes={k: tuple(v)
                                   for k, v in man["var_shapes"].items()})
