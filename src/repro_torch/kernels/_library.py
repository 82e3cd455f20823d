"""The ``repro_torch`` operator namespace: each kernel's launch as a
``torch.library`` op.

An op has three parts: its CUDA implementation (the launch: the checks,
the ``ctypes`` call and the wrapper's ``.launches`` counter, which moves
there and nowhere else), a fake implementation that gives the outputs'
shapes, dtypes and strides and touches neither ``torch.cuda`` nor the
build (it also serves meta tensors, on which ``launch/dryrun.py`` traces
a step), and a FLOP formula that ``torch.utils.flop_counter`` reads.
CPU tensors never reach an op: the wrappers run the plain versions for
them before any op is called.

The ops are defined with ``torch.library.Library``, whose eager dispatch
costs less host time than ``torch.library.custom_op``'s Python layers.
Defining them compiles nothing and allocates nothing.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

NAMESPACE = "repro_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")


def define(schema: str, cuda, fake, flops):
    """Defines ``repro_torch::<schema>``: ``cuda`` its CUDA implementation,
    ``fake`` its shape-only one, ``flops`` its FLOP formula (given the
    arguments with each tensor as its shape, and ``out_shape``).  Returns
    the op."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    op = getattr(getattr(torch.ops, NAMESPACE), name)
    register_flop_formula(op)(flops)
    return op
