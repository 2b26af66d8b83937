"""repro_torch — the PyTorch + CUDA port of the RNT-J columnar writer.

A twin of the ``repro`` package, module for module: ``repro_torch.core``
holds the writer and reader (their host algorithms copied unchanged),
``repro_torch.kernels`` the CUDA kernels for NVIDIA Hopper with their
plain PyTorch versions, ``repro_torch.models`` the dense, rwkv6 and
zamba2 models, ``repro_torch.pipeline`` the corpus ingest and the
packing loader, ``repro_torch.train`` the one-card train step, AdamW and
the training loop, ``repro_torch.ckpt`` the checkpoint,
``repro_torch.skim`` the paper's dataset skim, ``repro_torch.launch`` the
launchers (train, quickstart, serve, skim and the rest), and
``repro_torch.configs`` the paper's writer configuration and the ten
architectures.  Writers, readers, loaders, models, the train state, the
loop, the skim and the launchers take ``device=`` (default ``"cuda"``);
the CPU runs only when asked for.
"""

__version__ = "0.1.0"
