"""``FRCNN`` facade (counterpart of the JAX package's ``frcnn.py``): the
reference's user-facing wrapper — construct by mode, ``get_data_loader()``,
``get_network()``, ``load_param()`` / ``save_param()`` — plus ``train()``,
over config, :class:`Trainer` and the model.

    reference                               here
    ---------                               ----
    FRCNN('train')                          FRCNN('train')
    .get_data_loader(root_dir, bs, shuffle) .get_data_loader(root_dir, bs, shuffle)
    .get_network()                          .get_network() -> (model, state dict)
    .load_param(path) / .save_param(path)   same names (manifest-verified
                                            checkpoints, ``train/fault.py``)

Everything runs on ``cuda`` unless ``device="cpu"`` is passed. A torch
ResNet ``.pth`` for the backbone (the JAX facade's ``load_param`` of a
``.pth``) needs ``Trainer.load_pretrained_backbone``, which the port does
not have yet (ROADMAP Queue A item 9): ``load_param`` raises for one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from replication_faster_rcnn_tpu_torch.config import FasterRCNNConfig, get_config
from replication_faster_rcnn_tpu_torch.device import DeviceLike

PRETRAINED_NOT_PORTED = ("grafting a torch ResNet .pth into the backbone is not ported yet "
                         "(ROADMAP Queue A item 9)")


class FRCNN:
    """Thin convenience wrapper over config + Trainer + model."""

    def __init__(self, mode: str = "train", config: Optional[FasterRCNNConfig] = None,
                 device: DeviceLike = None):
        if mode not in ("train", "test"):
            raise ValueError("mode should be train or test")
        self.mode = mode
        self.config = config if config is not None else get_config("voc_resnet18")
        self.device = device
        self._trainer = None

    def get_data_loader(self, root_dir: Optional[str] = None, batch_size: int = 2,
                        shuffle: bool = True):
        """The dataset's loader (the reference's default batch size 2 and VOC
        root kept); ``root_dir`` replaces ``data.root_dir``."""
        from replication_faster_rcnn_tpu_torch.data.loader import DataLoader, make_dataset

        cfg = self.config
        if root_dir is not None:
            cfg = cfg.replace(data=dataclasses.replace(cfg.data, root_dir=root_dir))
            self.config = cfg
        split = "train" if self.mode == "train" else "val"
        return DataLoader(
            make_dataset(cfg.data, split), batch_size=batch_size, shuffle=shuffle,
            seed=cfg.train.seed, prefetch=cfg.data.loader_prefetch,
            num_workers=cfg.data.loader_workers,
            augment_hflip=cfg.data.augment_hflip and self.mode == "train",
            cache_ram=cfg.data.loader_cache_ram,
        )

    def get_network(self) -> Tuple[object, dict]:
        """(model, state dict): the whole detector, seeded from
        ``train.seed``, on the facade's device."""
        from replication_faster_rcnn_tpu_torch.models.faster_rcnn import build_model

        model = build_model(self.config, device=self.device, seed=self.config.train.seed)
        self.model, self.variables = model, model.state_dict()
        return self.model, self.variables

    @property
    def trainer(self):
        if self._trainer is None:
            from replication_faster_rcnn_tpu_torch.train.trainer import Trainer

            self._trainer = Trainer(self.config, device=self.device)
        return self._trainer

    def load_param(self, load_path: str) -> None:
        """Warm-start the trainer from the newest verified checkpoint in the
        directory ``load_path``; where it saves stays unchanged."""
        if load_path.endswith((".pth", ".pt")):
            raise NotImplementedError(PRETRAINED_NOT_PORTED)
        self.trainer.restore(directory=load_path)

    def save_param(self, save_path: str) -> None:
        """Save a checkpoint of the trainer's state into ``save_path``."""
        self.trainer.workdir = save_path
        self.trainer._ckpt_mgr = None
        self.trainer.save()
        print(f"parameters saved to {save_path}")

    def train(self, lr: Optional[float] = None, n_epoch: Optional[int] = None,
              save_folder: Optional[str] = None, load_path: Optional[str] = None):
        """The reference's ``trainer.train(lr, n_epoch, save_folder,
        load_path)`` on :class:`Trainer`; returns its last logged row."""
        cfg = self.config
        kw = {}
        if lr is not None:
            kw["lr"] = lr
        if n_epoch is not None:
            kw["n_epoch"] = n_epoch
        if kw:
            cfg = cfg.replace(train=dataclasses.replace(cfg.train, **kw))
            self.config = cfg
            self._trainer = None
        if save_folder is not None:
            from replication_faster_rcnn_tpu_torch.train.trainer import Trainer

            self._trainer = Trainer(cfg, device=self.device, workdir=save_folder)
        if load_path is not None:
            self.load_param(load_path)
        return self.trainer.train()
