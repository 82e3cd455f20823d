"""PyTorch/CUDA port of the ``repro`` serving path for NVIDIA Hopper.

The package mirrors ``repro``'s layout module for module.  It imports
``torch`` and never JAX; its kernels are written by hand in CUDA C++
under ``csrc/`` and are built at first use, so importing the package
needs neither a GPU nor a compiler.
"""
