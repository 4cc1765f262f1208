"""infw_torch — the ingress node firewall dataplane in PyTorch and CUDA.

A port of the JAX package ``infw`` to PyTorch on an NVIDIA H100, held
bit-identical against it.  This package imports ``torch`` and never
``jax`` or ``infw``.  The dense classify path runs end to end:

    spec -> validate -> compiler.compile_tables -> backend.cuda.TorchClassifier
    (packets.pack_wire -> kernels.torchpath.unpack_wire -> kernels.dense
    kernel K1 -> finalize/result_stats -> one device-to-host read)

Kernels are hand-written CUDA under ``kernels/csrc`` and are built with
``nvcc`` on first use.
"""
