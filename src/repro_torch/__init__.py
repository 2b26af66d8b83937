"""repro_torch — the PyTorch + CUDA port of the RNT-J columnar writer.

A twin of the ``repro`` package, module for module: ``repro_torch.core``
holds the writer and reader (their host algorithms copied unchanged),
``repro_torch.kernels`` the CUDA kernels for NVIDIA Hopper with their
plain PyTorch versions, ``repro_torch.models`` the dense, rwkv6 and
zamba2 models, ``repro_torch.pipeline`` the corpus ingest and the
packing loader, ``repro_torch.train`` the one-card train step and AdamW,
``repro_torch.launch.serve`` the serving launcher, and
``repro_torch.configs`` the paper's writer configuration and the ten
architectures.  Writers, readers, loaders, models, the train state and
the launcher take ``device=`` (default ``"cuda"``); the CPU runs only
when asked for.
"""

__version__ = "0.1.0"
