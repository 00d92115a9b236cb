"""Package metadata + console entry points.

Parity with the reference ``setup.py`` (console scripts ``rag-launcher``
and ``rag-system``, ``setup.py:38-43``; extras ``dev``/``full``), updated
for the TPU-native stack.
"""

from setuptools import find_packages, setup

setup(
    name="modular-rag-system-tpu",
    version="0.5.0",
    description=(
        "TPU-native RAG framework: batched JAX encoder, HBM-resident "
        "index with fused Pallas top-k, mesh-sharded search, host "
        "orchestration"
    ),
    packages=find_packages(include=["modular_rag_system_tpu*"]),
    package_data={
        # ship the C++ source: the native text engine builds itself with
        # g++ on first use (no prebuilt binaries in the wheel)
        "modular_rag_system_tpu.native": ["*.cpp"],
        # the PyTorch port's CUDA kernels build from source with nvcc at
        # first use (modular_rag_system_tpu_torch/kernels/__init__.py)
        "modular_rag_system_tpu_torch.kernels": ["*.cu", "*.cuh"],
        # bundled assets must ship in the wheel too, or an installed
        # package loses the default encoder and the external eval set
        # (works-only-from-source-checkout bug, ADVICE r4)
        "modular_rag_system_tpu": [
            "assets/default_encoder/*",
            "assets/eval/*.json",
            "assets/train/*.json",
        ],
    },
    include_package_data=True,
    python_requires=">=3.10",
    install_requires=[
        "numpy",
        "jax",
        "flax",
        "optax",
    ],
    extras_require={
        "dev": ["pytest"],
        "full": ["orbax-checkpoint", "chex", "einops"],
        # the PyTorch/CUDA port (modular_rag_system_tpu_torch)
        "torch": ["torch"],
        # optional capture adapters (reference requirements.txt parity)
        "capture": ["pynput"],
    },
    entry_points={
        "console_scripts": [
            "rag-tpu=modular_rag_system_tpu.launcher:main",
            # the PyTorch/CUDA port's launcher (same flags, plus --device)
            "rag-tpu-torch=modular_rag_system_tpu_torch.launcher:main",
            # reference script-name parity
            "rag-launcher=modular_rag_system_tpu.launcher:main",
            "rag-system=modular_rag_system_tpu.launcher:main",
        ]
    },
)
