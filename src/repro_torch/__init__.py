"""ApproxJoin in PyTorch, with hand-written CUDA kernels for Hopper.

The package mirrors ``repro`` (the JAX/Pallas implementation) module for
module and function for function: ``core/`` holds the operator, ``kernels/``
the three CUDA kernels with their plain PyTorch versions, ``data/`` the
synthetic workloads.  It never imports JAX or ``repro``.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU.  A CPU tensor handed to a kernel wrapper takes the kernel's plain
PyTorch version; a CUDA tensor launches the kernel or raises.
"""
