"""HBM Management Module on one device — the port of ``HMM.__init__`` and
``HMM.boot`` of ``repro.core.hmm``.

The HMM owns the model weights and the KV cache independently of the
serving instance.  Two expert stores (``expert_mode``): dense banks
``blocks/moe/{wi,wg,wo}`` ``[L, E, D, F|D]`` (the reference's default), or
a page *pool* per bank (``moe_pool/{wi,wg,wo}`` [pages, D, F|D]) addressed
through the ``ExpertPageTable``'s index arrays; both cover the ``L -
first_k_dense`` MoE layers.  Two KV layouts (``kv_mode``): the
slot-contiguous cache ``[L, B, max_len, KVH, hd]`` (the default; an MLA
model's latent ``{c: [L, B, max_len, r], kr: [L, B, max_len, dr]}``; a
Mamba2 model's per-slot ``{conv, state}`` and a hybrid's shared-attention
``{attn_k, attn_v}``), or a block pool ``[L, NB, bs, KVH, hd]`` with its
host-side ``KVBlockManager`` (standard attention only, as the reference
asserts).

``kv_dtype="int8"`` stores the KV pool as int8 entries with per-token f32
scale pools on the same block axis; ``expert_dtype="int8"`` stores the
expert banks as int8 pages with per-page f32 scale banks
(``moe_pool/{wi,wg,wo}_scale``) addressed by the same page table.  As in
the reference, they need the paged KV pool and the pooled store.

Scaling (``begin_scale``/``commit``, P2P page moves, KV migration),
rebalancing and parking need several devices or belong to later slices;
their knobs raise ``NotImplementedError``.
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
from repro_torch.kernels.quant import quantize_rows
from repro_torch.models.model import (dense_cache_supported, init_cache,
                                      init_expert_bank, init_paged_cache,
                                      init_params, paged_cache_supported)
from repro_torch.serving.kv_blocks import KVBlockManager


def not_ported(knob: str, value, default) -> None:
    """Refuse a knob of the reference outside this slice."""
    if value != default:
        raise NotImplementedError(
            f"{knob}={value!r} is not ported yet (only {default!r})")


class HMM:
    """Holds the weights and the KV cache of a one-device instance."""

    def __init__(self, mcfg, tp: int, *, batch_per_replica: int,
                 max_len: int, all_devices=None, seed: int = 0,
                 kv_mode: str = "dense", kv_block_size: int = 16,
                 kv_blocks_per_replica: Optional[int] = None,
                 expert_mode: str = "dense",
                 expert_pool_pages: Optional[int] = None,
                 expert_slot_slack: int = 0,
                 expert_host_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 expert_dtype: Optional[str] = None,
                 staging: str = "serial", transfer_workers: int = 4,
                 device="cuda"):
        not_ported("staging", staging, "serial")
        not_ported("expert_slot_slack", expert_slot_slack, 0)
        not_ported("expert_host_pages", expert_host_pages, None)
        not_ported("all_devices", all_devices, None)
        if kv_mode not in ("dense", "paged"):
            raise ValueError(f"unknown kv_mode {kv_mode!r}")
        if expert_mode not in ("dense", "pooled"):
            raise ValueError(f"unknown expert_mode {expert_mode!r}")
        if expert_mode == "pooled" and not mcfg.is_moe:
            raise ValueError(f"{mcfg.name}: expert_mode='pooled' requires a "
                             f"MoE model")
        if not dense_cache_supported(mcfg):
            raise ValueError(f"{mcfg.name}: only standard-attention, "
                             f"MLA and Mamba2 decoders are ported")
        if kv_mode == "paged" and not paged_cache_supported(mcfg):
            raise ValueError(f"{mcfg.name} does not support the paged KV "
                             f"layout (MLA caches its latent per slot, "
                             f"Mamba2 its SSD state)")
        if kv_mode == "paged" and max_len % kv_block_size:
            raise ValueError("max_len must be a multiple of kv_block_size")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r} (None or "
                             f"'int8')")
        if expert_dtype not in (None, "int8"):
            raise ValueError(f"unsupported expert_dtype {expert_dtype!r} "
                             f"(None or 'int8')")
        # the int8 stores keep their scales per block and per page
        if kv_dtype is not None and kv_mode != "paged":
            raise ValueError("kv_dtype='int8' requires kv_mode='paged' "
                             "(block-wise scales)")
        if expert_dtype is not None and expert_mode != "pooled":
            raise ValueError("expert_dtype='int8' requires "
                             "expert_mode='pooled' (per-page scales)")
        self.kv_dtype = kv_dtype
        self.expert_dtype = expert_dtype
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

    def expert_page_nbytes(self) -> int:
        """Bytes of ONE (layer, expert) page across all three banks; int8
        pages count their entries plus the three per-page f32 scales that
        travel with them."""
        bpe = torch_dtype(self.expert_dtype or self.mcfg.dtype).itemsize
        scale = 3 * 4 if self.expert_dtype is not None else 0
        return 3 * self.mcfg.d_model * self.mcfg.moe_d_ff * bpe + scale

    @obs.traced("hmm.boot", cat="hmm")
    def boot(self, cfg: ElasticConfig, params=None) -> float:
        """First boot on one device: draw the parameters on the device (or
        take ``params``, the reference's converted parameters in this HMM's
        expert layout — ``convert.params_from_jax``), fill the expert
        store, and create the KV cache (and, paged, its block manager).
        Returns the seconds it took."""
        if cfg.ndev != 1 or cfg.tp != 1 or self.tp != 1:
            raise NotImplementedError(
                f"{cfg.describe()} (tp={self.tp}): configurations with more "
                f"than one device are not ported yet")
        t0 = time.perf_counter()
        if self.expert_mode == "pooled":
            L, E = self._n_moe_layers, self.mcfg.num_experts
            # one device: every (layer, expert) page lives in the one pool
            self.expert_pool_pages = self.expert_pool_pages or L * E
            self.page_table = ExpertPageTable(
                L, E, pool_pages_per_device=self.expert_pool_pages)
            self.page_table.initial_place(cfg)
            layout = pooled_layout(self.page_table.active, cfg, L, E,
                                   self.expert_pool_pages)
            params = (self._init_pooled_params(cfg, layout) if params is None
                      else self._adopt(params, layout))
        else:
            params = (self._init_dense_params() if params is None
                      else self._adopt(params))
        self.params = params
        if self.kv_mode == "paged":
            self.cache = init_paged_cache(
                self.mcfg, cfg.dp * self.kv_blocks_per_replica,
                self.kv_block_size, device=self.device,
                kv_dtype=self.kv_dtype)
            self.kv_blocks = KVBlockManager(cfg.dp,
                                            self.kv_blocks_per_replica,
                                            self.kv_block_size)
        else:
            self.cache = init_cache(self.mcfg,
                                    cfg.dp * self.batch_per_replica,
                                    self.max_len, device=self.device)
        self.active_cfg = cfg
        self.boot_s = time.perf_counter() - t0
        return self.boot_s

    def _expert_banks(self):
        """Yield each MoE layer's freshly drawn routed expert bank
        ``(l, {wi, wg, wo})`` on the device, from one generator seeded
        with ``seed + 1``: both stores hold the same numbers."""
        mcfg, dev = self.mcfg, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed + 1)
        for l in range(self._n_moe_layers):
            yield l, init_expert_bank(mcfg, gen, torch_dtype(mcfg.dtype),
                                      dev)

    def _init_dense_params(self):
        """Random parameters with dense expert banks ``blocks/moe/{wi, wg,
        wo}`` [L, E, D, F|D], filled one layer at a time, so the banks (58
        GB at full size) are never held twice."""
        mcfg, dev = self.mcfg, self.device
        params = init_params(mcfg, self.seed, device=dev)
        if not mcfg.is_moe:
            return params
        L, E = self._n_moe_layers, mcfg.num_experts
        D, Fd = mcfg.d_model, mcfg.moe_d_ff
        dtype = torch_dtype(mcfg.dtype)
        moe = params["blocks"]["moe"]
        for k, shape in (("wi", (D, Fd)), ("wg", (D, Fd)), ("wo", (Fd, D))):
            moe[k] = torch.empty((L, E, *shape), dtype=dtype, device=dev)
        for l, bank in self._expert_banks():
            for k in ("wi", "wg", "wo"):
                moe[k][l] = bank.pop(k)
            del bank
        return params

    def _init_pooled_params(self, cfg: ElasticConfig, layout):
        """Random parameters with the experts written layer by layer
        straight into their ``initial_place`` pages: the dense banks are
        never held beside the pool (at full size that would be the 58 GB
        of expert weights twice).  With ``expert_dtype="int8"`` each
        layer's freshly drawn bank is quantized on the device, one scale
        per (layer, expert) page, and its int8 pages and scales are written
        through the same rows."""
        mcfg, dev = self.mcfg, self.device
        dtype = torch_dtype(mcfg.dtype)
        params = init_params(mcfg, self.seed, device=dev)
        rows = cfg.ndev * self.expert_pool_pages
        D, Fd = mcfg.d_model, mcfg.moe_d_ff
        quant = self.expert_dtype is not None
        pdt = torch.int8 if quant else dtype
        pool = {"wi": torch.zeros((rows, D, Fd), dtype=pdt, device=dev),
                "wg": torch.zeros((rows, D, Fd), dtype=pdt, device=dev),
                "wo": torch.zeros((rows, Fd, D), dtype=pdt, device=dev)}
        banks = list(pool)
        if quant:
            for k in banks:
                pool[k + "_scale"] = torch.zeros((rows,), dtype=torch.float32,
                                                 device=dev)
        for l, bank in self._expert_banks():
            pages = torch.from_numpy(layout["gtable"][l].astype(np.int64)
                                     ).to(dev)
            for k in banks:
                if quant:
                    pool[k][pages], pool[k + "_scale"][pages] = \
                        quantize_rows(bank.pop(k), (-2, -1))
                else:
                    pool[k][pages] = bank.pop(k)
            del bank
        params["blocks"]["moe"].update(
            {k: torch.from_numpy(v).to(dev) for k, v in layout.items()})
        params["moe_pool"] = pool
        return params

    def _adopt(self, params, layout=None):
        """Move given parameters to the device, checking that they are in
        this HMM's expert layout: dense banks (``layout`` None), or the
        pooled store whose page tables are this HMM's placement."""
        moe = params["blocks"].get("moe", {})
        if layout is None:
            if "moe_pool" in params or (self.mcfg.is_moe
                                        and "wi" not in moe):
                raise ValueError("params must hold dense expert banks "
                                 "(blocks/moe/wi, wg, wo) for "
                                 "expert_mode='dense'")
        else:
            if "moe_pool" not in params or "gtable" not in moe:
                raise ValueError("params must be in the pooled layout "
                                 "(moe_pool + blocks/moe/gtable)")
            got = moe["gtable"].cpu().numpy()
            if not np.array_equal(got, layout["gtable"]):
                raise ValueError("params' page tables differ from the "
                                 "initial placement of this configuration")
            pool = params["moe_pool"]
            quant = self.expert_dtype is not None
            if (pool["wi"].dtype == torch.int8) != quant \
                    or ("wi_scale" in pool) != quant:
                raise ValueError(f"params' expert pool ({pool['wi'].dtype}, "
                                 f"scales: {'wi_scale' in pool}) does not "
                                 f"match expert_dtype={self.expert_dtype!r}")

        def move(t):
            if isinstance(t, dict):
                return {k: move(v) for k, v in t.items()}
            if isinstance(t, list):
                return [move(v) for v in t]
            return t.to(self.device).contiguous()
        return move(params)
