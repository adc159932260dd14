"""repro_torch — the PyTorch/CUDA port of ``repro``, for an NVIDIA H100.

``core/``, ``obs/`` and ``analysis/`` are byte-identical copies of the JAX
package's I/O-aware task runtime (pure Python, relative imports only), so
the port depends on nothing of ``repro``. The model layers mirror
``repro.models`` in PyTorch; the Pallas flash-attention kernel is a CUDA C++
kernel for ``sm_90a`` (``kernels/flash_attention``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
