"""HBM Management Module on one device — the port of ``HMM.__init__`` and
``HMM.boot`` of ``repro.core.hmm`` for the paged-KV, pooled-expert path.

The HMM owns the model weights and the KV pool independently of the
serving instance.  Expert weights live as a page *pool* per bank
(``moe_pool/{wi,wg,wo}`` [pages, D, F|D]) addressed through the
``ExpertPageTable``'s index arrays; the KV cache is a block pool
``[L, NB, bs, KVH, hd]`` with its host-side ``KVBlockManager``.

Scaling (``begin_scale``/``commit``, P2P page moves, KV migration), the
int8 stores, rebalancing and parking need several devices or belong to
later slices; their knobs raise ``NotImplementedError``.
"""
from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.expert_pages import ExpertPageTable, pooled_layout
from repro_torch.core.topology import ElasticConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models.model import (init_expert_bank, init_paged_cache,
                                      init_params, paged_cache_supported)
from repro_torch.serving.kv_blocks import KVBlockManager


def not_ported(knob: str, value, default) -> None:
    """Refuse a knob of the reference outside this slice."""
    if value != default:
        raise NotImplementedError(
            f"{knob}={value!r} is not ported yet (only {default!r})")


class HMM:
    """Holds the weights and the KV pool of a one-device instance."""

    def __init__(self, mcfg, tp: int, *, batch_per_replica: int,
                 max_len: int, all_devices=None, seed: int = 0,
                 kv_mode: str = "paged", kv_block_size: int = 16,
                 kv_blocks_per_replica: Optional[int] = None,
                 expert_mode: str = "pooled",
                 expert_pool_pages: Optional[int] = None,
                 expert_slot_slack: int = 0,
                 expert_host_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 expert_dtype: Optional[str] = None,
                 staging: str = "serial", transfer_workers: int = 4,
                 device="cuda"):
        not_ported("kv_mode", kv_mode, "paged")
        not_ported("expert_mode", expert_mode, "pooled")
        not_ported("staging", staging, "serial")
        not_ported("kv_dtype", kv_dtype, None)
        not_ported("expert_dtype", expert_dtype, None)
        not_ported("expert_slot_slack", expert_slot_slack, 0)
        not_ported("expert_host_pages", expert_host_pages, None)
        not_ported("all_devices", all_devices, None)
        if not mcfg.is_moe:
            raise ValueError(f"{mcfg.name}: expert_mode='pooled' requires a "
                             f"MoE model")
        if not paged_cache_supported(mcfg):
            raise ValueError(f"{mcfg.name} does not support the paged KV "
                             f"layout")
        if max_len % kv_block_size:
            raise ValueError("max_len must be a multiple of kv_block_size")
        self.device = resolve_device(device)
        self.mcfg = mcfg
        self.tp = tp
        self.batch_per_replica = batch_per_replica
        self.max_len = max_len
        self.seed = seed
        self.transfer_workers = transfer_workers
        self.kv_mode = kv_mode
        self.expert_mode = expert_mode
        self.kv_block_size = kv_block_size
        # dense-equivalent capacity by default; pressure experiments pass a
        # smaller pool to force preemption
        self.kv_blocks_per_replica = (
            kv_blocks_per_replica
            or batch_per_replica * (max_len // kv_block_size))
        self.expert_pool_pages = expert_pool_pages
        self.page_table: Optional[ExpertPageTable] = None
        self.kv_blocks: Optional[KVBlockManager] = None
        self.active_cfg: Optional[ElasticConfig] = None
        self.params: Any = None
        self.cache: Any = None
        self.boot_s = 0.0

    @property
    def _n_moe_layers(self) -> int:
        return self.mcfg.num_layers - self.mcfg.first_k_dense

    @obs.traced("hmm.boot", cat="hmm")
    def boot(self, cfg: ElasticConfig, params=None) -> float:
        """First boot on one device: draw the parameters on the device (or
        take ``params``, the reference's converted pooled-layout parameters
        — ``convert.params_from_jax``), fill the pooled expert store, and
        create the KV pool and its block manager.  Returns the seconds it
        took."""
        if cfg.ndev != 1 or cfg.tp != 1 or self.tp != 1:
            raise NotImplementedError(
                f"{cfg.describe()} (tp={self.tp}): configurations with more "
                f"than one device are not ported yet")
        t0 = time.perf_counter()
        L, E = self._n_moe_layers, self.mcfg.num_experts
        # one device: every (layer, expert) page lives in the one pool
        self.expert_pool_pages = self.expert_pool_pages or L * E
        self.page_table = ExpertPageTable(
            L, E, pool_pages_per_device=self.expert_pool_pages)
        self.page_table.initial_place(cfg)
        layout = pooled_layout(self.page_table.active, cfg, L, E,
                               self.expert_pool_pages)
        if params is None:
            params = self._init_pooled_params(cfg, layout)
        else:
            params = self._adopt(params, layout)
        self.params = params
        self.cache = init_paged_cache(
            self.mcfg, cfg.dp * self.kv_blocks_per_replica,
            self.kv_block_size, device=self.device)
        self.kv_blocks = KVBlockManager(cfg.dp, self.kv_blocks_per_replica,
                                        self.kv_block_size)
        self.active_cfg = cfg
        self.boot_s = time.perf_counter() - t0
        return self.boot_s

    def _init_pooled_params(self, cfg: ElasticConfig, layout):
        """Random parameters with the experts written layer by layer
        straight into their ``initial_place`` pages: the dense banks are
        never held beside the pool (at full size that would be the 58 GB
        of expert weights twice)."""
        mcfg, dev = self.mcfg, self.device
        dtype = torch_dtype(mcfg.dtype)
        params = init_params(mcfg, self.seed, device=dev)
        rows = cfg.ndev * self.expert_pool_pages
        D, Fd = mcfg.d_model, mcfg.moe_d_ff
        pool = {"wi": torch.zeros((rows, D, Fd), dtype=dtype, device=dev),
                "wg": torch.zeros((rows, D, Fd), dtype=dtype, device=dev),
                "wo": torch.zeros((rows, Fd, D), dtype=dtype, device=dev)}
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed + 1)
        for l in range(self._n_moe_layers):
            bank = init_expert_bank(mcfg, gen, dtype, dev)
            pages = torch.from_numpy(layout["gtable"][l].astype(np.int64)
                                     ).to(dev)
            for k in pool:
                pool[k][pages] = bank[k]
            del bank
        params["blocks"]["moe"].update(
            {k: torch.from_numpy(v).to(dev) for k, v in layout.items()})
        params["moe_pool"] = pool
        return params

    def _adopt(self, params, layout):
        """Move given pooled-layout parameters to the device, checking that
        their page tables are this HMM's placement."""
        if "moe_pool" not in params or \
                "gtable" not in params["blocks"]["moe"]:
            raise ValueError("params must be in the pooled layout "
                             "(moe_pool + blocks/moe/gtable)")
        got = params["blocks"]["moe"]["gtable"].cpu().numpy()
        if not np.array_equal(got, layout["gtable"]):
            raise ValueError("params' page tables differ from the initial "
                             "placement of this configuration")

        def move(t):
            if isinstance(t, dict):
                return {k: move(v) for k, v in t.items()}
            if isinstance(t, list):
                return [move(v) for v in t]
            return t.to(self.device).contiguous()
        return move(params)
