"""Model factory (port of ``easydgl_tpu.models.registry``).

All eleven models of the JAX zoo are ported: EasyDGL, SASREC, BERT4REC,
CTSMA, GRU4REC, S2PNM, GREC, TiSASREC, TimelyREC, TGAT and TGREC. A name
outside ``MODELS`` raises the JAX factory's ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

from easydgl_tpu_torch.config import Config
from easydgl_tpu_torch.device import resolve_device
from easydgl_tpu_torch.models.base import SequentialModel
from easydgl_tpu_torch.models.bert4rec import BERT4REC
from easydgl_tpu_torch.models.ctsma import CTSMA
from easydgl_tpu_torch.models.easydgl import EasyDGL
from easydgl_tpu_torch.models.grec import GREC
from easydgl_tpu_torch.models.gru4rec import GRU4REC
from easydgl_tpu_torch.models.s2pnm import S2PNM
from easydgl_tpu_torch.models.sasrec import SASREC
from easydgl_tpu_torch.models.tgat import TGAT
from easydgl_tpu_torch.models.tgrec import TGREC
from easydgl_tpu_torch.models.timelyrec import TimelyREC
from easydgl_tpu_torch.models.tisasrec import TiSASREC

MODELS = {"EasyDGL": EasyDGL, "SASREC": SASREC, "BERT4REC": BERT4REC,
          "CTSMA": CTSMA, "GRU4REC": GRU4REC, "S2PNM": S2PNM, "GREC": GREC,
          "TiSASREC": TiSASREC, "TimelyREC": TimelyREC, "TGAT": TGAT,
          "TGREC": TGREC}


def model_class(cfg: Config) -> type:
    """The port's class of ``cfg.model``; the JAX factory's
    ``NotImplementedError`` for a name outside ``MODELS``."""
    if cfg.model not in MODELS:
        raise NotImplementedError(
            f"The ranking model: {cfg.model} not implemented")
    return MODELS[cfg.model]


def build_model(cfg: Config, *, device=None,
                params: Optional[dict] = None) -> SequentialModel:
    """The model for ``cfg`` on ``device`` (default ``cuda``; raises if
    there is none), in eval mode, with weights from ``params`` — a flax-
    layout param tree of numpy arrays — or, without it, drawn from
    ``cfg.seed`` with the flax initializers (parity.random_flax_params)."""
    from easydgl_tpu_torch import parity
    cls = model_class(cfg)
    dev = resolve_device(device)
    model = cls(cfg, device=dev)
    if params is None:
        params = parity.random_flax_params(cfg, cfg.seed)
    model.load_state_dict(parity.flax_to_torch(params))
    return model.eval()
