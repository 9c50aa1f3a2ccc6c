#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints its seconds; any failed check raises, and the run
exits non-zero):

  1. device        — the card's name, and ``nvidia-smi``'s name and power
                     limit;
  2. build         — compiles every CUDA source of the port with nvcc
                     (one process per source, all at once) into
                     ``build/repro_torch/`` and prints ptxas' resource
                     report (registers and spills of every instance);
  3. characterize  — the 160-chip characterization of 365 d / 1000 P/E and
                     the attempt histograms of all six mechanisms, on the
                     card, bit for bit the CPU's: the margin arrays'
                     digest equal to this host's CPU run and to the pin
                     of a CPU run (which equals the JAX reference's), the
                     histograms' digest and the record's exact fields to
                     the pins, ``mean_margin_final`` to this host's mean
                     of the CPU's margins;
  4. kernels       — the shard-core kernel against its plain torch version
                     on the same card tensors, bit for bit over each
                     case's first ``KERNEL_HOLD_STEPS`` steps, on the
                     padded op tables of ``websearch`` at 20 000 requests
                     (``baseline`` serial and ``pr2ar2`` pipelined; FIFO,
                     and priority rings with aging bounds inf and 8), on
                     one 48-lane table stacking all six mechanisms, on the
                     same table with each mechanism's own serial or
                     pipelined lanes (FIFO, and priority rings at bound
                     8), and on ``baseline``'s table padded to 16 384 rows,
                     too wide for shared memory; then on lanes of 17, 32,
                     64 and 100 dies (``WIDE_DIES``: the 32-slot, 64-slot
                     and generic instances, ``websearch`` at 4 000
                     requests, baseline's serial and pr2ar2's pipelined
                     lanes), FIFO from shared memory and, padded to
                     16 384 rows, priority rings from global memory; each
                     case prints its variant (op table and rings in shared
                     or global memory) and its shared-memory bytes a
                     block, and the variant must be the one the shapes
                     call for; then the floor of one step's dependency
                     chain (a probe kernel of dependent f64 max and adds);
  5. main path     — ``compare_mechanisms`` over the six mechanisms at
                     20 000 requests with ``engine="batched"``; the kernel
                     must have launched, every launch from shared memory
                     (``smem_launches``), and ``baseline`` / ``pr2ar2``
                     must equal the array interpreter's SimStats.  The
                     host side of the run is timed by phase (trace,
                     simulators, ``_prepare``, ``_lane_tables``,
                     ``pad_ops``, step and ring bounds, ``augment_ops``,
                     the launch and its copies, result assembly).  The six
                     mechanisms then run again unfused (one launch each),
                     and every cell's SimStats must equal the fused run's.
                     Every launch of the fused run is then held against
                     the plain version on the inputs it had, bit for bit,
                     and timed beside its bounds: bytes or operations,
                     and the serial chain (longest lane's steps x the
                     measured floor).
  5b. wide channels — the same ``compare_mechanisms`` on 8 channels x 32
                     dies with ``engine="auto"``: every mechanism must
                     select ``"batched"`` with no fallback reason; its
                     launches (``wide_launches``; 48 lanes of 32 dies)
                     are held against the plain version over their first
                     ``GC_HOLD_STEPS`` steps and timed beside their
                     bounds.
  6. serve kernels — the count of HGMMA (wgmma) instructions in the SASS
                     of each flash-attention instance (``cuobjdump
                     -sass``), nonzero for every bfloat16 one; the
                     flash-attention kernel against its plain dense
                     softmax on the full-width llama3.2-3b prefill shape
                     (B 4, T 2048, 24 heads over 8 KV heads, hd 128,
                     causal, bf16; its time, TFLOP/s and share of the
                     bound printed), the same shape at hd 64, a window +
                     softcap case (hd 256) and a kv_valid case, with
                     ``scaled_dot_product_attention`` timed beside the
                     causal cases (bfloat16 outputs are
                     held element by element: one bfloat16 ulp of the
                     plain value plus 2^-8 of the row's rms), and two
                     faulty variants of the plain version on the causal
                     case (p rounded to bfloat16 before P.V, a dropped
                     key tile) that must fail that rule; the KV retry kernel
                     against its plain version on one full-width decode
                     leaf (28 x 4 x 8 x 2048 pages of 128 bf16 values),
                     with its variant (the vector kernel: lanes a page,
                     pages in flight a thread), its share of the bytes
                     bound, the warp-per-page kernel's time on the same
                     leaf and ``quantize_pages`` of the leaf (the store's
                     re-quantization, a measurement only); then 65 536
                     pages whose margins lie within 1e-6 of 0 (sums exact
                     in any order), held by the same rule;
  7. serve path    — ``ServeEngine`` on the card, first at a small width
                     held against the same engine on the CPU (equal
                     tokens and KV read stats), then llama3.2-3b at full
                     width with seeded weights: ``launch/serve.py``'s
                     request set (4 prompts of 4-11 tokens) and a long
                     set (4 prompts of 1024-2048 tokens), 16 new tokens
                     each, under pr2ar2 (tau 0.05) and baseline engines
                     sharing the weights.  The launch counts are set to 0
                     just before each run and read just after; both
                     kernels must have launched, every flash-attention
                     launch through the tensor-core kernel
                     (``tc_launches``) and every KV retry launch through
                     the vector kernel (``vec_launches``), pr2ar2 must
                     serve some pages fast
                     and baseline none, and every logit must be finite; then the short set under pr2ar2 at tau
                     0.01, where pages must retry (B3's backing read)
                     and others be fast.  Every launch of each run is
                     then held against the plain version on the inputs
                     it had, and timed beside its bound;
  8. ssd/rber kernels — the HGMMA count of each SSD scan instance
                     (nonzero for the bf16 chunk scan; 0 for the chunk
                     states, state passing and scores kernels and the
                     SIMT kernel); the SSD scan against
                     its plain
                     version on
                     the full-width mamba2-130m long prefill shape (B 4,
                     T 2048, 24 heads, hd 64, ds 128, chunk 256, bf16:
                     the tensor-core path),
                     a padded case (T 1500) and a float32 case (the SIMT
                     kernel; bfloat16
                     y held element by element as in phase 6, H and
                     float32 y within 1e-5 of their largest), and two
                     faulty variants of the plain version (w rounded to
                     bfloat16; the carried state not decayed across
                     chunks) that must fail that rule; the time of each
                     kernel of the tensor-core path alone on the long
                     case; then
                     ``rber_table`` over the 160-chip population's
                     (mu, sigma) at 365 d / 1000 P/E and the 41-entry
                     retry table, its count set to 0 just before and
                     read just after, held against its plain version
                     and against the characterization's
                     ``rber_per_retry_step``; its bare time (100
                     launches of the typed C entry queued behind a
                     sleeping stream) beside its time through the
                     wrapper, and its bound with the operations of one
                     erfcf and one IEEE division read from the SASS of
                     the library's probes (``cuobjdump -sass``);
  9. mamba serve path — ``ServeEngine`` with mamba2-130m, first at its
                     reduced width (head dim 16, ds 16) on the card
                     against the CPU (equal tokens, logits within 1e-4
                     of the largest), then at full width with seeded
                     weights: the short and long sets, 16 new tokens,
                     under pr2ar2 and baseline.  Each prefill must launch
                     the scan 24 times, every launch on the tensor-core
                     path (``tc_launches``), the KV store read 0 pages, the
                     two mechanisms give equal tokens and every logit be
                     finite; every launch is held and timed as above;
 10. sweep runtime — ``run_sweep`` over ``websearch`` at 20 000 requests,
                     365 d / 1000 P/E and 30 d / 0 P/E, all six
                     mechanisms, seeds 0-31, ``engine="batched"``, at
                     workers 1 (inline), 2 and 4 (spawned workers, each
                     with its own CUDA context, launching the shard-core
                     kernel): the three ``sweep_to_json`` outputs must be
                     byte-identical, every cell fused on the kernel; the
                     launches of each sweep are read off the cells'
                     ``fused_cells`` (workers' launches are not counted in
                     this process) and, inline, must equal the kernel's
                     count, set to 0 just before and read just after; the
                     wall of each, a seed group's share and each pool's
                     start-up (first result minus pool creation) are
                     printed beside ``nvidia-smi``'s name and power
                     limit.  Then the array engine on seed 0's sub-grid
                     (both conditions, baseline and pr2ar2) must give the
                     batched sweep's bytes; a journaled sweep at 4
                     workers, cut to its header and first record, must
                     resume inline to the same bytes launching only the
                     missing seed groups; 12 ``simulate`` cells of two
                     seeds through ``run_cells`` must fuse across cells,
                     one launch a chunk; ``compare_mechanisms(engine=
                     "array", workers=2)`` (forked workers on the host)
                     must equal workers 1; and the inline sweep's first
                     launch is held against the plain version, bit for
                     bit, and timed;
 11. prepass GC   — ``compare_mechanisms`` over the paper's write-heavy
                     ``prn`` profile at 20 000 requests, 365 d / 1000
                     P/E, all six mechanisms, ``gc="prepass"`` (the FTL
                     auto-sized at 7% over-provisioning),
                     ``engine="batched"``: the shard-core count set to 0
                     just before and read just after must equal the
                     chunks read off ``fused_cells``; it prints the
                     launch's placement (``smem_launches`` against
                     ``launches``) and the lanes the card holds at once,
                     and the host phases with ``build_ftl_schedule``.
                     Every cell must equal the array interpreter's and
                     the unfused run's, with WA > 1, ``gc_invocations ==
                     blocks_erased > 0`` and the same FTL stats for every
                     mechanism.  The first GC launch must hold erases
                     (kind 2) and low-priority GC reads; it is timed in
                     full, equal to its re-run bit for bit, and its first
                     ``GC_HOLD_STEPS`` steps are held against the plain
                     version, bit for bit.
                     ``baseline`` and ``pr2ar2`` under
                     ``host_prio_aged:4`` (the GC reads through the aged
                     priority rings) must equal the array interpreter;
                     mean and read p99 are printed beside the in-place
                     ``prn`` run's; then ``run_sweep`` of ``prn`` over
                     both phase-10 conditions, ``baseline`` and
                     ``pr2ar2``, seeds 0-3, at 300 P/E an erase (blocks
                     reach the worn P/E bins, characterized on the card)
                     must give the same bytes at workers 1 and 2
                     (spawned);
 12. closed loop  — the open-loop half of the closed loop's contract:
                     the 12 cells of ``tests/data/golden_closed_loop.json``
                     that need neither online GC nor faults (``prn`` and
                     ``websearch`` at 600 requests, 365 d / 1000 P/E) on
                     the card's characterization, every pinned field
                     equal except ``die_util`` and ``channel_util``
                     (within 4 ulps); the 8 whose scheduler has a ring
                     lowering also through ``engine="batched"`` and
                     ``"auto"``, the shard-core count set to 0 before
                     them and the deep queue's open-loop run and read
                     after, each batched launch held against the plain
                     version bit for bit and each auto launch equal to
                     it.  Then a QD ladder (``ncq_depth`` 1-32) of
                     ``websearch`` at 20 000 requests for ``baseline`` and
                     ``sota+pr2ar2``: IOPS monotone with a knee,
                     ``max_inflight <= qd``, ``mean_us`` equal to queue
                     wait + device time + host overhead, and pipelining
                     winning IOPS and read p99 at QD 8; ``ncq_depth``
                     20 000 equal to the open-loop batched run; the
                     batched engine's refusal and auto's recorded
                     fallback; and the ``prn`` GC cell closed at QD 32
                     (``baseline``, ``pr2ar2``, with and without a host
                     write-back cache), its host wall, IOPS, wait/device
                     split and cache counters printed;
 13. online GC    — the other 20 cells of ``golden_closed_loop.json``
     and faults      (online|none, online|fc, off|fc, prepass|fc) on the
                     card's characterization through ``engine="array"``
                     and ``"auto"`` (equal, fallback recorded, no
                     shard-core launch), each refused by
                     ``engine="batched"``; ``compare_mechanisms`` of
                     ``prn`` at 20 000 requests, all six mechanisms,
                     ``gc="online"``: WA, GC passes, write stalls,
                     prefill skips, read mean and p99 printed beside
                     phase 11's prepass and in-place cells, and
                     ``pr2ar2`` with ``shard=True`` equal to it; the
                     golden ``fc`` faults on ``prn`` (``pr2ar2``) online,
                     prepass, and prepass closed at QD 32 (its fault
                     counters equal to the open loop's); the reference's
                     recovery-ladder cell (``rsrch``, 2 000 requests,
                     ``uncorrectable_prob=0.6``, one escalation): parity
                     rebuilds, rebuild reads and retired blocks > 0, and
                     ``shard=True`` equal; AR²'s reliability guard
                     (``websearch``, six mechanisms, ``FaultConfig()``):
                     mispredictions and read mean/p99 beside
                     ``faults=None``, none for the non-adaptive
                     mechanisms; a pooled online sweep with faults
                     (``prn``, 600 requests, seeds 0-1) byte-identical at
                     workers 1 and 2 (spawned); every run's host wall,
                     the fault model's derived rates on the card's
                     characterization, and the phase's seconds against
                     its 150 s budget.  The shard-core count over the
                     whole phase must be 0.  The fault model's ``p_mis``
                     and ``p_unc`` on the card equal the pinned CPU run's.
 14. calibrate     — ``core.calibrate.evaluate(DEFAULT_NAND)`` on the
                     card equal to this host's CPU run and the pinned
                     metrics, and, when it fits its budget, the 108-set
                     grid with the pinned CPU best; no kernel launch;
 15. train         — llama3.2-3b at its published widths, all 28 layers,
                     batch 2 x 1024, six steps of ``launch.train.train``
                     (flash tier, prefetch, loss, backward, AdamW): the
                     loss finite and falling, the flash tier's stats the
                     CPU's, one step profiled (device-busy share, kernels
                     by time), peak memory; then a 1-layer copy at full
                     widths saves a checkpoint at step 3, a corrupted
                     shard is rebuilt on restore, the restore equals the
                     saved state bit for bit, and the resumed steps 4-6
                     equal the uninterrupted run's losses bit for bit
                     (deterministic algorithms); no kernel launch;
 16. recurrent and MoE serve path — the RG-LRU and MoE families:
                     ``ServeEngine`` at the reduced width on the card
                     against the CPU as in phase 7 (recurrentgemma at 8
                     layers, two units and a tail of two RG-LRU layers;
                     olmoe; llama4-maverick with its sigmoid router,
                     shared expert and MoE every second layer), each
                     router call's picks compared and a differing token
                     printed with its k-th and (k+1)-th probabilities;
                     then recurrentgemma-2b (26 layers) and olmoe-1b-7b
                     (16 layers, 64 experts, top-8) at full width and
                     depth with seeded weights, each served as
                     llama3.2-3b is in phase 7 (short and long sets under
                     pr2ar2 and baseline, the short set at tau 0.01),
                     every prefill launching flash attention once an
                     attention layer (8 local MQA layers at hd 256; 16
                     MHA layers with qk-norm at hd 128) and every
                     pr2ar2 decode step the KV retry read once a KV leaf,
                     all on the tensor-core and vector kernels, each
                     launch held against its plain version and timed;
                     the all-zero pages of recurrentgemma's local ring
                     (prompts shorter than its window) read by the KV
                     retry kernel and its plain version alike, margins
                     finite; parameters, memory, prefill and decode
                     times and token agreement printed; then a few
                     training steps of each at full widths and cut
                     depths (recurrentgemma one unit and its tail, olmoe
                     two layers with its aux loss): losses finite, no
                     kernel launch;
 17. encoder-decoder and VLM serve path — whisper-large-v3 and
                     internvl2-1b: at the reduced width (head dim 64) the
                     card against the CPU, prefill and two decode steps
                     over seeded random frame or patch embeddings (logits
                     within 1e-4 of the largest) and ``ServeEngine``'s
                     tokens and KV read stats equal; then both at full
                     width and depth with seeded weights, served as in
                     phase 16 with long sets of 224-432 tokens (whisper's
                     decoder context of 448 with 16 new tokens) and
                     768-1792 (internvl's 2048 with 256 patches): every
                     whisper prefill launches flash attention 96 times
                     (32 bidirectional encoder layers at T = S = 1500,
                     32 causal and 32 cross decoder layers) and every
                     internvl prefill 24 times (causal, 14 heads over 2
                     KV heads), every pr2ar2 decode step the KV retry
                     read once a KV leaf (whisper's self and cross k and
                     v, internvl's k and v), all on the tensor-core and
                     vector kernels; each flash-attention launch held
                     and timed (summed by mode: bidirectional, causal,
                     cross), each internvl KV read held, and whisper's of
                     the first and last decode step (the others counted:
                     its cross leaves are 491.5 MB); then a few training
                     steps of each at full widths through the launcher
                     (whisper 2 + 2 layers over 448 tokens and 1500
                     frames: losses finite; internvl all 24 layers: the
                     first loss finite, the rest as ROADMAP C12 makes
                     them on its zero patches) and internvl's steps on
                     seeded random patches (losses finite); no kernel
                     launch.
 18. int8 KV cache and Mamba-2 training — (a) ``python -m
                     repro_torch.launch.serve --smoke --arch A`` in-process
                     for every published arch (reduced configs, head dim
                     16): every B4 launch on the SIMT kernel
                     (``small_hd_launches``) and every B3 launch on E 16
                     held against the plain version, mamba2-130m
                     launching B5 and reading no KV page; with
                     ``REPRO_KV_INT8=1``: (b) the small-width check of
                     llama3.2-3b, tailed recurrentgemma (the local ring's
                     scales) and whisper (the cross scales) with the CPU
                     decoding from the card's cache, tokens and KV stats
                     equal, int8 elements at most a level apart; (c)
                     llama3.2-3b at full width and depth served as in
                     phase 7 (B3 recorded only), every B3 launch on int8
                     backing (``int8_launches``) and held bit for bit,
                     margins too, the int8 cache's bytes against bf16's
                     and B3's time a launch against its bytes bound; (d)
                     whisper-large-v3 at full width, the short set, B3 on
                     its int8 self and cross leaves, the first and last
                     decode steps held; then (e) mamba2-130m trained at
                     24 layers, d 768, batch 2 x 1024, four AdamW steps
                     through the launcher: losses finite and falling, no
                     kernel launch (the SSD blocks train through the
                     plain scan), then served on the trained weights
                     (24 B5 launches a prefill), and the reduced
                     mamba2-130m's float32 loss and gradients on the card
                     within 1e-5 of the CPU's.
 19. sharded steps — ``repro_torch.distributed`` at world size 1 (NCCL
                     takes one card a rank): (a) a one-rank NCCL process
                     group through a ``FileStore`` under ``build/``, the
                     host mesh (``launch.mesh.make_host_mesh``) on the
                     card and one all-reduce; (b) llama3.2-3b at its
                     published widths, all 28 layers, batch 2 x 1024,
                     three steps of ``launch.train.train`` on the (1, 1)
                     mesh (``distributed.steps.make_train_step``: DTensor
                     parameters and moments, units gathered just in time)
                     with phase 15's seed, rate, schedule and
                     deterministic setting: the losses equal phase 15's
                     first three bit for bit (else within 1e-5 relative,
                     printed as such), peak memory printed, no kernel
                     launch; ``compress_grads`` on a seeded gradient tree
                     equal to the CPU's bit for bit; (c) olmoe-1b-7b at
                     full width and depth with ``REPRO_MOE_EP=1``:
                     ``make_prefill_step`` on the long set through the
                     expert-parallel body (64 local experts), B4 16
                     launches a prefill, each held against the plain
                     version with the bfloat16 rule; the logits against
                     the dense dispatch's prefill of the same weights by
                     the same rule; three ``make_decode_step`` steps whose
                     greedy tokens equal the unsharded ``decode_step``'s;
                     the serve steps take and return the cell's
                     placements (DTensors, whole on one rank), and one
                     prefill and decode step of each dispatch under
                     ``launch.cost.trace`` issue no collective on the
                     "model" group; (d) mamba2-130m at full width and
                     depth (Mamba-2's products divided over "model"
                     where it divides them, the identity on one rank):
                     ``make_prefill_step`` on the short set through B5
                     (24 launches, each held against the plain version
                     and counted apart, ``dist_launches``), then one
                     ``make_decode_step`` step whose greedy tokens equal
                     the unsharded ``prefill`` and ``decode_step``'s bit
                     for bit, 0 collectives on the "model" group under
                     ``launch.cost.trace``, the case's seconds printed.
 20. dryrun        — ``repro_torch.launch.dryrun`` on the card's host: (a)
                     for each distinct B4 and B5 launch of phases 6-19
                     (inputs' shapes, dtypes and strides, the static
                     arguments), the custom op's fake implementation
                     gives the real launch's output shapes, dtypes and
                     strides; (b) full-width cells traced over a fake
                     16 x 16 process group (``run_cells``, one process a
                     cell, all at once, started before phase 18 and
                     tracing beside phases 18 and 19 on the host's cores;
                     they use no device): llama3.2-3b ``train_4k``,
                     ``prefill_32k`` and ``decode_32k``, mamba2-130m
                     ``prefill_32k`` and olmoe-1b-7b ``prefill_32k`` under
                     ``ep``, and the kernel stand-ins' variants:
                     llama3.2-3b ``train_4k`` under ``flash`` (markers
                     101/102) and ``decode_32k`` under ``flash+kvint8``
                     (402), mamba2-130m ``train_4k`` under ``ssdk``
                     (30256/40256), each record's bytes, FLOPs,
                     collectives and ``trace_s`` printed (the two
                     mamba2-130m cells' ``dot`` and ``kernel`` beside
                     their counts with Mamba-2's products whole over
                     "model", ``DRYRUN_WHOLE_SSM``), each serve
                     cell's ``step_argument_bytes`` equal to its
                     ``argument_bytes`` (the steps take their shards),
                     each stand-in cell's ``kernel`` FLOPs equal to the
                     marker formula summed over the config's layers
                     (computed here) and
                     its ``dot`` below the ``base`` cell's where that cell
                     runs; (c) one real cell: llama3.2-3b's
                     prefill at B 1 x T 2048 from ``build_cell`` on a
                     one-rank NCCL mesh, its ``FlopCounterMode`` count
                     equal to the dry-run's of the same cell, its B4 op
                     calls equal to the kernel's launches, its inputs'
                     bytes equal to the dry-run's ``argument_bytes``, and
                     the dry-run's ``temp_bytes`` printed beside
                     ``torch.cuda.max_memory_allocated`` of the step; the
                     card's ``total_memory`` printed with ``nvidia-smi``'s
                     name and power limit (the dry-run's
                     ``CARD_MEMORY_BYTES``); (c') llama3.2-3b's decode
                     step at B 1 over a 2 048-slot cache, bf16 and int8,
                     from ``build_cell`` on the one-rank NCCL mesh: its
                     ``FlopCounterMode`` count equal to the ``dot +
                     kernel`` of the same cell's dry-run under ``flash``
                     (``flash+kvint8``), printed with the card's name and
                     power limit; (d) each kernel stand-in called on CUDA
                     tensors raises (none has a device implementation).

The line before the last is a JSON object describing each kernel
(launches on its main path, error against the plain version, and times
and bound summed over the main path's held launches; for flash attention
and the KV retry read, phases 7, 16, 17 and 18 together, with phase
16's launches also apart (``family_launches``), phase 17's
(``encdec_launches``; ``encdec_held`` KV reads of them held), phase
18's B4 launches at head dim 16 (``small_hd_launches``; with
``tc_launches`` they make up every launch; their held times apart in
``small_hd_ms``, ``small_hd_plain_ms``, ``small_hd_bound_ms`` and not
in the row's sums, since SDPA has no softcap for gemma2's), phase 19's
B4 launches (``dist_launches``, not in ``launches``; their held times
in ``dist_ms``, ``dist_plain_ms``, ``dist_bound_ms``, not in the row's
sums) and phase 18's B3
launches on int8 backing (``int8_launches``, ``int8_held`` of them held,
their times also in ``int8_ms``, ``int8_plain_ms``,
``int8_bound_ms``); for the
shard core also
the inline sweep's counted launches and its held launch, the
prepass-GC compare's counted launches and its held launch, the
closed-loop phase's counted launches and its held launches, and the
online/fault phase's launches, which must be 0); the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CACHE = ROOT / "build" / "chip_smoke_cache"

WORKLOAD = "websearch"
N_REQUESTS = 20000
CONDITION = (365.0, 1000.0)
MECHANISMS = ("baseline", "sota", "pr2", "ar2", "pr2ar2", "sota+pr2ar2")
KERNEL_REPS = 5
#: Phase 4 holds each case's first this many lockstep steps against the
#: plain core (kernel and plain version both stopped there); phase 5
#: holds the main path's launch whole, phase 5b its wide cell's launches
#: over their first GC_HOLD_STEPS.
KERNEL_HOLD_STEPS = 16384
#: Phase 4's wide lanes: dies a channel, and the requests of the
#: ``websearch`` trace their tables come from.
WIDE_DIES = (17, 32, 64, 100)
WIDE_CASE_REQUESTS = 4000
#: Phase 5b: the main path's cell on channels of this many dies (8
#: channels x 32 dies, 256 dies).
WIDE_CELL_DIES = 32
CHAIN_PROBE_STEPS = 1 << 21
DEVICE = "cuda"

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 rate and dense
# float64 outside the tensor cores; the kernel's arithmetic is f64 adds
# and maxes.
HBM_BYTES_PER_S = 3.35e12
F64_OPS_PER_S = 34e12
# Dense bf16 tensor-core peak, and float32 outside the tensor cores.
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12

SERVE_ARCH = "llama3.2-3b"
SERVE_TAU = 0.05
SERVE_MAX_NEW = 16
LONG_LENGTHS = (2048, 1024, 1536, 1792)
# Full-width llama3.2-3b prefill attention: B, T, heads, KV heads, hd.
PREFILL_SHAPE = (4, 2048, 24, 8, 128)
# The decode-leaf case's tolerance: at 0.02 a page of 128 values whose
# largest value dominates its rms retries and a Gaussian page does not
# (at 0.05 no page of 128 values can retry: the ratio is at most
# 0.5 * sqrt(128) / (127 * 0.05) = 0.89).
LEAF_TAU = 0.02
FA_F32_TOL = 1e-5
KV_MARGIN_RTOL = 1e-6
# The serve run whose pages retry: a page of 128 values retries where
# tau < max|v| / (254 rms); seeded KV pages are near Gaussian, with
# max/rms about 2.6 over 128 values, so about half retry at 0.01.
RETRY_TAU = 0.01

SSM_ARCH = "mamba2-130m"
# Full-width mamba2-130m long-set scan launch: B, T, heads, hd, ds, chunk.
SSD_SHAPE = (4, 2048, 24, 64, 128, 256)
SSD_PADDED_T = 1500
# float32 scan cases: y and H within 1e-5 of their largest magnitude (the
# plain version takes the kernel's cumulative-sum order; only product
# orders differ).  bfloat16 y is held element by element, as B4's.
SSD_F32_TOL = 1e-5
# The characterization's population: 160 chips x 8 blocks x 16 pages.
N_BLOCKS = 8
N_PAGES = 16
# RBER table: against its plain version (both call CUDA's erfcf), and
# against the characterization's rber_per_retry_step (which divides by
# sqrt(2) and takes sqrt(sigma^2 + 0) as the sensing sigma).
RBER_RTOL = 1e-6
RBER_CHAR_RTOL = 1e-4
RBER_ATOL = 1e-12
# Launches of the RBER kernel queued behind a sleeping stream for its
# bare time (no host time between them).
RBER_BARE_REPS = 100

# Phase 10: the paper grid swept by run_sweep at these worker counts
# (1 inline, the rest spawned), the array engine on a one-seed sub-grid,
# and cross-cell fusion over two seeds' simulate cells.
SWEEP_CONDITIONS = ((365.0, 1000.0), (30.0, 0.0))
SWEEP_SEEDS = tuple(range(32))
SWEEP_WORKERS = (1, 2, 4)
SWEEP_ARRAY_MECHANISMS = ("baseline", "pr2ar2")
FUSION_SEEDS = (0, 1)

# Phase 11: prepass GC on the paper's write-heavy profile, the priority
# rings on two mechanisms, and a worn-bin sweep (blocks gain this many
# P/E cycles an erase, so they snap to the higher characterization bins).
GC_WORKLOAD = "prn"
GC_PRIO_SCHEDULER = "host_prio_aged:4"
GC_PRIO_MECHANISMS = ("baseline", "pr2ar2")
GC_WEAR_SEEDS = (0, 1, 2, 3)
GC_PEC_PER_ERASE = 300.0
#: The GC launch's prefix held against the plain core (kernel and plain
#: version both stopped after this many lockstep steps): the whole
#: launch's ~720 k steps take the plain core ~160 s on the card.
GC_HOLD_STEPS = 65536

# Phase 12: the closed loop.  The pinned open-loop cells, the
# schedulers with a ring lowering, the QD ladder and its mechanisms,
# and the GC cell's queue depth and mechanisms.
CLOSED_GOLDEN = ROOT / "tests" / "data" / "golden_closed_loop.json"
CLOSED_RING = ("fcfs", "host_prio", "host_prio_aged:8")
CLOSED_ULPS = 4
CLOSED_LADDER = (1, 2, 4, 8, 16, 32)
CLOSED_MECHANISMS = ("baseline", "sota+pr2ar2")
CLOSED_GC_QD = 32
CLOSED_GC_MECHANISMS = ("baseline", "pr2ar2")

# Phase 13: online GC and faults.  The golden matrix's cells the batched
# engine refuses; online GC at the paper's size; the golden ``fc`` fault
# configuration at the paper's size (online, prepass, and prepass closed
# at this queue depth); the reference's recovery-ladder cell; AR²'s
# reliability guard on ``websearch``; a small pooled sweep; the phase's
# host budget in seconds.
FAULT_MECHANISM = "pr2ar2"
FAULT_QD = 32
RECOVERY_CELL = dict(workload="rsrch", n_requests=2000, seed=3)
RECOVERY_FAULTS = dict(uncorrectable_prob=0.6, escalation_attempts=1)
ONLINE_SWEEP_N = 600
ONLINE_SWEEP_SEEDS = (0, 1)
ONLINE_BUDGET_S = 150.0
FAULT_FIELDS = ("mispredicted_reads", "rescued_reads", "parity_rebuilds",
                "rebuild_reads", "retired_blocks", "program_fails",
                "erase_fails", "unrecoverable")

# Pins of the characterization at CONDITION from a CPU run of the port
# (``characterize_condition(365, 1000, device="cpu")`` with the disk cache
# off, torch 2.13 CPU, numpy 2.0.2, x86-64), which equal the JAX
# reference's (``tests/test_torch_xla_math.py``): the sha256 of the
# float32 margin arrays at the success entry (lsb, csb, msb in turn,
# 160 x 8 x 16 each), the record's fields that are exact functions of
# them, and phase 13's fault rates.  ``mean_margin_final`` and
# ``p01_margin_final`` are reduced by the host's numpy (a float32 mean,
# a percentile), whose summation order differs between numpy versions,
# so they are held card against CPU on the same host, not against a pin.
PIN_MARGIN_SHA256 = ("04da380e1dcef006858392994b6493b2"
                     "de4af49539078cab19747f810ee698cf")
# sha256 over the 12 attempt histograms of the six mechanisms (sorted
# keys, each key's repr then its float64 bytes), the same CPU run.
PIN_HIST_SHA256 = ("ef1c2c0b81c3c01c4b623df4df9cafa4"
                   "3622c0eb52dbe3e15b2bd1e35936697b")
PIN_STATS = dict(mean_retry_steps=12.723372395833334, p99_retry_steps=16.0,
                 frac_reads_with_retry=1.0, safe_tr_scale=0.75)
PIN_P_MIS = 0.013897299766540527
PIN_P_UNC = 5.054473876953125e-05

# Phase 14: the calibration fit.  The nine metrics of
# evaluate(DEFAULT_NAND) and of the 108-set grid's best, as a CPU run of
# the port gives them (torch 2.13 CPU, numpy 2.0.2, x86-64; equal to the
# reference's ``core/calibrate.py`` under jax 0.9.0).  The two margin
# metrics are float32 means and percentiles by the host's numpy, whose
# summation order changes between versions: they are held through their
# input (the worst-condition margins' sha256, pinned from the same run)
# and to the host's numpy reduction of it, and printed beside the pins.
# The 108-set grid runs when this many seconds cover it.
HOST_NUMPY_METRICS = ("t2_margin_mean", "t2_margin_p01")
PIN_EVALUATE = {
    "t1_mean_steps_3mo": 4.603971354166666,
    "t2_worst_mean_steps": 15.756901041666667, "t2_worst_fail_frac": 0.0,
    "t2_margin_mean": 0.3879348039627075,
    "t2_margin_p01": 0.011046426370739937,
    "t3_ratio_075": 1.016428162564396, "t3_ratio_070": 1.0240412135088723,
    "t4_fresh_steps": 0.0, "t5_sota_aged_steps": 5.737369791666667}
PIN_EVALUATE_MARGINS = ("cc8c97724abd055c8dbf2e0503b0ad75"
                        "227d779986c8144e4dcf2d14a13d967e")
CALIBRATE_GRID_BUDGET_S = 150.0
PIN_GRID_BEST = dict(alpha_r=0.082, sigma_r=0.003, sense_eta=0.16,
                     retry_step_v=0.05)
PIN_GRID_SCORE = 102.17419287982851
PIN_GRID_METRICS = {
    "t1_mean_steps_3mo": 4.2662109375,
    "t2_worst_mean_steps": 16.041731770833334, "t2_worst_fail_frac": 0.0,
    "t2_margin_mean": 0.3422516882419586,
    "t2_margin_p01": 0.00907350517809391,
    "t3_ratio_075": 1.0355935744560227, "t3_ratio_070": 1.0657880977086425,
    "t4_fresh_steps": 0.0, "t5_sota_aged_steps": 5.824674479166666}
PIN_GRID_MARGINS = ("3573185585a14bc45cfaf83edd7c6c7b"
                    "ec8e0c09981eb11af4231a6e254aa07f")

# Phase 15: training llama3.2-3b at its published widths, all 28 layers,
# batch 2 x 1024 tokens, pr2ar2 flash tier at CONDITION; the checkpoint
# round trip and the resume on a depth-cut copy (full widths, this many
# layers: the full state is 51 GB); the flash tier's stats over
# TRAIN_STEPS batches as the CPU gives them (same seed and corpus).
TRAIN_ARCH = "llama3.2-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 1024, 6
# AdamW at 3e-4 (the optimizer's default) with 2 warmup steps diverges
# from a random 3B initialization (losses 12.1 -> 18.8 -> 22.4 in six
# steps on an H100 80GB HBM3 at 700 W); a few steps of a smoke run take
# a smaller rate.
TRAIN_LR = 2e-5
CKPT_LAYERS, CKPT_STEPS, CKPT_AT = 1, 6, 3
PIN_FLASH_STATS = dict(batches=6, pages=6, attempts=81,
                       sim_read_us=3715.1249999999995)

# Phase 16: the RG-LRU and MoE families.  At the reduced width, card
# against CPU (recurrentgemma with a tail: 2 units + 2 tail layers; at
# head dim 64: phase 18 holds the reduced head dim of 16); at published
# widths and depths through ServeEngine; and trained at published widths
# and these depths (recurrentgemma one unit and the tail of 2).
FAMILY_SMALL = (("recurrentgemma-2b", dict(n_layers=8, head_dim=64)),
                ("olmoe-1b-7b", dict(head_dim=64)),
                ("llama4-maverick-400b-a17b", dict(head_dim=64)))
FAMILY_ARCHS = ("recurrentgemma-2b", "olmoe-1b-7b")
FAMILY_TRAIN = (("recurrentgemma-2b", 5), ("olmoe-1b-7b", 2))
FAMILY_TRAIN_STEPS = 3

# Phase 17: the encoder-decoder and VLM families.  At the reduced width
# (head dim 64; phase 18 holds 16), card against CPU;
# at published widths and depths through ServeEngine, with long sets of
# whisper's decoder context (448 positions = 432 + 16 new tokens) and of
# internvl's 2048 (256 patches + T); trained at published widths, whisper
# cut to 2 + 2 layers over its 448-token context, internvl at full depth.
ENCDEC_SMALL = (("whisper-large-v3", dict(head_dim=64)),
                ("internvl2-1b", dict(head_dim=64)))
ENCDEC_LONG = {"whisper-large-v3": (224, 432, 300, 380),
               "internvl2-1b": (768, 1792, 1024, 1536)}
ENCDEC_TRAIN = (("whisper-large-v3", dict(n_layers=2, n_enc_layers=2), 448),
                ("internvl2-1b", {}, TRAIN_SEQ))

# Phase 18: the int8 KV cache (REPRO_KV_INT8=1) at the reduced width,
# card against CPU (head dim 16: B4's SIMT kernel in float32), for the
# global cache, the local ring of a tailed recurrentgemma and whisper's
# cross scales; at full width through ServeEngine for llama3.2-3b (the
# request sets of phase 7) and whisper (the short set); mamba2-130m
# trained at published width and depth for a few steps.
INT8_SMALL = (("llama3.2-3b", {}), ("recurrentgemma-2b", dict(n_layers=8)),
              ("whisper-large-v3", {}))
INT8_ENCDEC = "whisper-large-v3"
MAMBA_TRAIN_STEPS = 4

# Phase 19: the sharded steps at world size 1 (NCCL takes one card a
# rank).  llama3.2-3b's sharded train step for this many of phase 15's
# steps (its seed, rate, schedule and deterministic setting), held to
# phase 15's losses bit for bit or, failing that, within this relative
# tolerance; compress_grads on a tree drawn from this seed; olmoe-1b-7b's
# expert-parallel prefill on the long set and this many decode steps.
DIST_TRAIN_STEPS = 3
DIST_LOSS_RTOL = 1e-5
DIST_COMPRESS_SEED = 19
DIST_MOE_ARCH = "olmoe-1b-7b"
DIST_DECODE_STEPS = 3
#: mamba2-130m's decode steps after its sharded prefill (phase 19 (d)):
#: one, as the whole script came within 100 s of its limit with three.
DIST_SSM_DECODE_STEPS = 1
#: The collective calls one sharded train step should make on the
#: one-rank (1, 1) mesh, counted from the code: global_norm's all-reduce
#: over each mesh dim and the heartbeat's all-gather.  The
#: tensor-parallel pieces add none where "model" has one rank.
DIST_STEP_COLLECTIVES = {"c10d.allreduce_": 2, "c10d._allgather_base_": 1}

# Phase 20: the dry-run.  Full-width cells (arch, shape, variant) traced
# over a fake 16 x 16 group, one process each, all at once (the last
# three under the kernel stand-ins); a prefill and a decode of this arch,
# batch and length (the decode's cache slots) run for real on one NCCL
# rank; the phase's budget in seconds.
DRYRUN_CELLS = (("llama3.2-3b", "train_4k", "base"),
                ("llama3.2-3b", "prefill_32k", "base"),
                ("llama3.2-3b", "decode_32k", "base"),
                ("mamba2-130m", "prefill_32k", "base"),
                ("olmoe-1b-7b", "prefill_32k", "ep"),
                ("llama3.2-3b", "train_4k", "flash"),
                ("llama3.2-3b", "decode_32k", "flash+kvint8"),
                ("mamba2-130m", "train_4k", "ssdk"))
DRYRUN_REAL = ("llama3.2-3b", 1, 2048)
#: (dot, kernel) FLOPs a rank of the mamba2-130m cells above as the
#: parent of the division of Mamba-2's products over "model" traced them
#: (every product whole over "model"), printed beside this run's.
DRYRUN_WHOLE_SSM = {("mamba2-130m", "prefill_32k", "base"):
                    (11809167040512.0, 4947802324992.0),
                    ("mamba2-130m", "train_4k", "ssdk"):
                    (58709250146304.0, 24739011624960.0)}
DRYRUN_BUDGET_S = 90.0
#: A (b) cell's limit in seconds: the cells start before phase 18 and
#: trace beside phases 18 and 19 on the host's cores (they use no
#: device).
DRYRUN_CELL_TIMEOUT_S = 600.0
#: Phase 20 (b)'s threads and results once started.
_DRYRUN = {}
#: Each distinct CUDA launch of B4 and B5 in this process: {kernel: {key:
#: (output shapes, dtypes, strides)}}, noted by ``setup()``'s wrappers.
LAUNCHED = {"flash_attention": {}, "ssd_scan": {}}


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            print(f"[{name}] done in {time.perf_counter() - t0:.3f} s",
                  flush=True)
            return out
        return run
    return wrap


def _cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


@phase("device")
def device_phase():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name} (count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})")
    print(smi)
    return name, smi


@phase("build")
def build_phase():
    from repro_torch.kernels import build

    libs = build.build_all(build.all_sources())
    for src, lib in libs.items():
        print(f"built {src.relative_to(ROOT)} -> {lib.relative_to(ROOT)}")
        for line in Path(f"{lib}.log").read_text().splitlines():
            if "Used" in line or "spill" in line or "entry function" in line:
                print(f"  ptxas: {line.strip()}")


def _char_tables(device):
    """Characterize CONDITION and the histograms of all six mechanisms."""
    from repro_torch.core import characterize as TC
    from repro_torch.core.retry import RetryPolicy

    stats = TC.characterize_condition(*CONDITION, device=device)
    hists = {}
    for m in MECHANISMS:
        pol = RetryPolicy(m)
        scale = stats.safe_tr_scale if pol.adaptive_tr else 1.0
        for pt in ("lsb", "csb", "msb"):
            hists[(pt, pol.sota_start, scale)] = TC.attempt_histogram(
                *CONDITION, page_type=pt, sota=pol.sota_start,
                tr_scale=scale, device=device)
    return stats, hists


def _fresh_cache(name):
    """Point the characterization cache at a new, empty directory inside
    the checkout, so the next characterization computes every table."""
    from repro_torch.core import characterize as TC

    cache = CACHE / name
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["REPRO_TORCH_CHAR_CACHE_DIR"] = str(cache)
    TC.clear_tables()


def _margins(device):
    """(sha256, numpy array) of the float32 ECC margins at the success
    entry of the 160-chip population at CONDITION (lsb, csb, msb), as
    ``characterize_condition`` computes them, on ``device``."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch.core import characterize as TC
    from repro_torch.core import constants as C
    from repro_torch.core import ecc, prng
    from repro_torch.core import retry as R

    parts = []
    for i, pt in enumerate(C.PAGE_TYPES):
        key = prng.fold_in(prng.PRNGKey(0, device=device), i)
        rber = TC._population_rber(key, *CONDITION, pt, C.N_CHIPS, N_BLOCKS,
                                   N_PAGES, 1.0, C.DEFAULT_NAND)
        k = R.first_success_step(rber)
        final = torch.take_along_dim(rber, k[..., None], dim=-1)[..., 0]
        parts.append(ecc.capability_margin(final).cpu().numpy().ravel())
    h = hashlib.sha256()
    for m in parts:
        h.update(m.tobytes())
    return h.hexdigest(), np.concatenate(parts)


def _hist_digest(hists):
    import hashlib

    h = hashlib.sha256()
    for k in sorted(hists):
        h.update(repr(k).encode())
        h.update(hists[k].tobytes())
    return h.hexdigest()


@phase("characterize")
def characterize_phase():
    """The card's characterization equals the CPU's bit for bit (C10):
    the margin arrays' digest equals this host's CPU run and the pinned
    CPU run, the record's mean margin equals this host's mean of the
    CPU's margins, its exact fields and the 12 histograms the pins."""
    import numpy as np
    import torch

    _fresh_cache(DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats, hists = _char_tables(DEVICE)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    digest, _ = _margins(DEVICE)
    t0 = time.perf_counter()
    cpu_digest, cpu_margins = _margins("cpu")
    cpu_s = time.perf_counter() - t0
    cpu_mean = float(cpu_margins.mean())
    hist_digest = _hist_digest(hists)
    print(f"card record {stats}; margin digests card {digest}, cpu "
          f"{cpu_digest}; histograms {hist_digest}", flush=True)
    if not digest == cpu_digest == PIN_MARGIN_SHA256:
        raise AssertionError(f"margin digests card {digest}, cpu "
                             f"{cpu_digest}, pinned {PIN_MARGIN_SHA256}")
    if stats.mean_margin_final != cpu_mean:
        raise AssertionError(f"mean_margin_final card "
                             f"{stats.mean_margin_final!r} != cpu {cpu_mean!r}")
    for name, want in PIN_STATS.items():
        if getattr(stats, name) != want:
            raise AssertionError(f"{name} {getattr(stats, name)!r} != "
                                 f"pinned {want!r}")
    if hist_digest != PIN_HIST_SHA256:
        raise AssertionError(f"histogram digest {hist_digest} != pinned "
                             f"{PIN_HIST_SHA256}")
    print(f"characterization {CONDITION[0]:g} d / {CONDITION[1]:g} P/E, "
          f"160 chips, {len(hists)} histograms: card {card_s:.3f} s "
          f"(the CPU's margins {cpu_s:.3f} s); margins, histograms and "
          f"exact fields equal the pinned CPU run, mean_margin_final "
          f"{stats.mean_margin_final!r} the CPU's on this host (numpy "
          f"{np.__version__})")
    print(f"safe_tr_scale = {stats.safe_tr_scale}, mean_retry_steps = "
          f"{stats.mean_retry_steps}, p99_retry_steps = "
          f"{stats.p99_retry_steps}")
    return dict(card_s=card_s, cpu_s=cpu_s)


def _main_path_tables(dies_per_channel=None, n_requests=N_REQUESTS,
                      mechanisms=MECHANISMS):
    """Padded op tables of the main path's cells (one per mechanism), on
    ``DEFAULT_SSD`` or its channels widened to ``dies_per_channel``."""
    import dataclasses

    from repro_torch.core.retry import RetryPolicy
    from repro_torch.flashsim import DEFAULT_SSD, OperatingCondition
    from repro_torch.flashsim import engine_batched as EB
    from repro_torch.flashsim import ssd
    from repro_torch.kernels.fcfs_core import ops as K

    cfg = DEFAULT_SSD if dies_per_channel is None else dataclasses.replace(
        DEFAULT_SSD, dies_per_channel=dies_per_channel)
    trace = ssd.resolve_trace(WORKLOAD, seed=0, n_requests=n_requests)
    expansion = ssd.expand_trace(trace, cfg)
    tables, pipelined = {}, {}
    for m in mechanisms:
        sim = ssd.SSDSim(cfg, OperatingCondition(*CONDITION),
                         RetryPolicy(m), seed=7, engine="batched",
                         device=DEVICE)
        prep = sim._prepare(trace, expansion=expansion)
        lanes, _, _ = EB._lane_tables(sim.cfg, prep.bufs)
        tables[m] = K.pad_ops(lanes)
        pipelined[m] = prep.pipelined
    t = cfg.timing
    return tables, pipelined, EB.dies_per_lane(cfg), (t.tdma_us, t.tecc_us)


def _bound_ms(ops, fin, diestat, lane):
    """The two times that bound one launch's work on the card: the bytes
    it must move over the HBM rate, and the f64 operations this run's
    steps need over the f64 peak (milliseconds, in that order).

    Bytes: columns 0-6 of every real op row and the arrival of the pad
    row each lane stops on, the timing rows, one completion time per
    real op, and the die and lane outputs.  Operations: each retired
    step (an admission or an event) compares time and seq over the die
    slots and the ACQ head, compares with the admission, and does at
    most four f64 adds or maxes of its own.
    """
    L, _, _ = ops.shape
    n_dies = diestat.shape[1]
    real = ops[:, :, 1] != 3.0
    n_real = int(real.sum())
    n_bytes = 8 * (7 * n_real + L + 3 * L) + \
        8 * (n_real + diestat.numel() + lane.numel())
    n_steps = n_real + float(lane[:, 2].sum())
    n_ops = n_steps * (2 * (n_dies + 1) + 5)
    return n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F64_OPS_PER_S * 1e3


def _bound(t_bytes, t_ops):
    """The least time (the larger of the two) and what sets it."""
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _longest_lane_steps(ops, lane):
    """Steps the longest lane of one launch retires (admissions plus
    events): the length of the serial chain that bounds the kernel."""
    real = (ops[:, :, 1] != 3.0).sum(dim=1).to(lane.dtype)
    return int((real + lane[:, 2]).max())


def _chain_ns_per_step(tdma, tecc):
    """Measured floor of one step's latency on the card: nanoseconds per
    link of the dependent f64 max-and-add chain a step carries to the
    next (``fcfs_chain_probe_launch`` in the kernel's source)."""
    import ctypes

    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.fcfs_core import ops as K

    fn = build.load(K._SOURCE).fcfs_chain_probe_launch
    fn.argtypes = [ctypes.c_longlong, ctypes.c_double, ctypes.c_double,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(2, dtype=torch.float64, device=DEVICE)
    stream = torch.cuda.current_stream().cuda_stream
    n = CHAIN_PROBE_STEPS

    def run():
        if fn(n, tdma, tecc, out.data_ptr(), stream) != 0:
            raise RuntimeError("chain probe launch failed")

    run()
    ms, _ = _cuda_ms(run, 3)
    if not torch.isfinite(out).all():
        raise AssertionError("chain probe gave a non-finite result")
    return ms * 1e6 / n


def _variant(ops, kw):
    """The kernel variant the wrapper takes for these shapes, and its
    dynamic shared-memory bytes a block."""
    from repro_torch.kernels.fcfs_core import ops as K

    shape = (ops.shape[1], kw["n_dies"], kw["capq"], kw["capw"], kw["prio"])
    place = K.placement(*shape, K.smem_budget(ops.device, kw["n_dies"]))
    if place == K.SMEM:
        return "smem", K.smem_bytes(*shape)
    return "global", 0


def _hold(name, ops, timing, steps, kw, got=None, plain_steps=None):
    """Hold one launch of the kernel against its plain version on the
    same card tensors, bit for bit, and time both.

    ``got`` is a launch's output recorded on the main path; without it
    the kernel's own timed launches give the output compared.  With
    ``plain_steps`` below ``steps``, the timed launches must equal
    ``got`` and the plain version is held against the kernel over the
    first ``plain_steps`` steps only (both stopped there)."""
    import torch

    from repro_torch.kernels.fcfs_core import ops as K
    from repro_torch.kernels.fcfs_core.plain import fcfs_core_plain

    K.fcfs_core_fwd(ops, timing, steps, **kw)          # warm-up
    ms, again = _cuda_ms(lambda: K.fcfs_core_fwd(ops, timing, steps, **kw),
                         KERNEL_REPS)
    got = full = again if got is None else got
    held_steps = steps if plain_steps is None else min(plain_steps, steps)
    if held_steps < steps:
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"{name}: the kernel's re-run differs "
                                 f"from the recorded launch")
        got = again = K.fcfs_core_fwd(ops, timing, held_steps, **kw)
    plain_ms, want = _cuda_ms(
        lambda: fcfs_core_plain(ops, timing, held_steps, **kw), 1)
    err = max(float((g - w).abs().nan_to_num(float("inf")).max())
              for g, w in zip(got, want))
    if err != 0.0 or not all(torch.equal(g, w) and torch.equal(g, a)
                             for g, w, a in zip(got, want, again)):
        raise AssertionError(f"{name}: kernel differs from plain version "
                             f"(max abs {err})")
    t_bytes, t_ops = _bound_ms(ops, *full)
    bound_ms, bound_by = _bound(t_bytes, t_ops)
    longest = _longest_lane_steps(ops, full[2])
    variant, smem = _variant(ops, kw)
    n_pip = int((timing[:, 3] != 0).sum())
    print(f"{name}: lanes {ops.shape[0]} ({n_pip} pipelined) maxp "
          f"{ops.shape[1]} steps {steps} longest lane {longest} variant "
          f"{variant} ({smem} B of shared memory a block) max_abs_err "
          f"{err} kernel {ms:.3f} ms ({ms * 1e6 / longest:.1f} ns per step "
          f"of the longest lane) plain {plain_ms:.1f} ms over "
          f"{held_steps} steps bound {bound_ms:.6f} ms ({bound_by})",
          flush=True)
    return dict(case=name, steps=steps, plain_steps=held_steps,
                longest=longest, ms=ms,
                plain_ms=plain_ms, t_bytes=t_bytes, t_ops=t_ops,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                variant=variant, smem=smem)


#: Rows of the phase-4 case too wide for a block's shared memory.
WIDE_MAXP = 16384


@phase("kernels")
def kernel_phase():
    import numpy as np
    import torch

    from repro_torch.kernels.fcfs_core import ops as K

    tables, pipelined, n_dies, (tdma, tecc) = _main_path_tables()
    cases = []
    for m in ("baseline", "pr2ar2"):
        for label, bound in (("fifo", None), ("prio-inf", float("inf")),
                             ("prio-8", 8.0)):
            cases.append((f"{m}/{label}", tables[m], pipelined[m], bound,
                          "smem", n_dies))
    stacked, mixed = _stack_lanes(tables, pipelined, MECHANISMS)
    cases.append(("six-mechanisms-48-lanes/fifo", stacked, True, None,
                  "smem", n_dies))
    cases.append(("six-mechanisms-48-lanes-mixed/fifo", stacked, mixed,
                  None, "smem", n_dies))
    cases.append(("six-mechanisms-48-lanes-mixed/prio-8", stacked, mixed,
                  8.0, "smem", n_dies))
    wide = K.pad_ops([row[np.isfinite(row[:, 0])]
                      for row in tables["baseline"]], maxp=WIDE_MAXP)
    cases.append((f"baseline-{WIDE_MAXP}-rows/fifo", wide,
                  pipelined["baseline"], None, "global", n_dies))
    # Wide lanes: baseline's serial and pr2ar2's pipelined lanes of one
    # table, FIFO from shared memory and, padded to WIDE_MAXP rows,
    # priority rings at bound 8 from global memory.
    for dies in WIDE_DIES:
        wt, wp, nd, _ = _main_path_tables(dies, WIDE_CASE_REQUESTS,
                                          ("baseline", "pr2ar2"))
        st, mx = _stack_lanes(wt, wp, ("baseline", "pr2ar2"))
        cases.append((f"{dies}-dies-16-lanes-mixed/fifo", st, mx, None,
                      "smem", nd))
        cases.append((f"{dies}-dies-16-lanes-mixed-{WIDE_MAXP}-rows/prio-8",
                      K.pad_ops([r[np.isfinite(r[:, 0])] for r in st],
                                maxp=WIDE_MAXP), mx, 8.0, "global", nd))

    results = []
    for name, ops_np, pip, bound, variant, n_dies in cases:
        prio = bound is not None
        L = ops_np.shape[0]
        pip = np.broadcast_to(np.asarray(pip, np.float64), (L,))
        capq, capw = K.ring_caps(ops_np, n_dies)
        ops = torch.as_tensor(K.augment_ops(ops_np, pip != 0),
                              dtype=torch.float64, device=DEVICE)
        timing = torch.as_tensor(np.stack(
            [np.full(L, tdma), np.full(L, tecc),
             np.full(L, bound if prio else 0.0), pip], axis=1),
            dtype=torch.float64, device=DEVICE)
        kw = dict(n_dies=n_dies, capq=capq, capw=capw, prio=prio)
        r = _hold(name, ops, timing, K.count_steps(ops_np), kw,
                  plain_steps=KERNEL_HOLD_STEPS)
        r["n_dies"] = n_dies
        if r["variant"] != variant:
            raise AssertionError(f"{name}: took the {r['variant']} variant, "
                                 f"the shapes call for {variant}")
        results.append(r)
    chain_ns = _chain_ns_per_step(tdma, tecc)
    print(f"chain floor: {chain_ns:.3f} ns per step (dependent f64 max "
          f"and adds, {CHAIN_PROBE_STEPS} links)", flush=True)
    return results, chain_ns


def _stack_lanes(tables, pipelined, mechanisms):
    """The mechanisms' lanes stacked into one table at the widest
    mechanism's padding, and each lane's pipelined flag."""
    import numpy as np

    from repro_torch.kernels.fcfs_core import ops as K

    widest = max(tables[m].shape[1] for m in mechanisms)
    stacked = np.concatenate(
        [K.pad_ops([row[np.isfinite(row[:, 0])] for row in tables[m]],
                   maxp=widest) for m in mechanisms], axis=0)
    mixed = np.concatenate([[pipelined[m]] * tables[m].shape[0]
                            for m in mechanisms])
    return stacked, mixed


def _outcome(s):
    import dataclasses

    return {f.name: getattr(s, f.name) for f in dataclasses.fields(s)
            if f.compare}


def _host_timers():
    """Wrap the host phases of ``compare_mechanisms``'s batched path in
    wall-clock timers.  Returns ``(seconds by phase, restore)``; nested
    phases (``augment_ops`` inside the dispatch, ``_prepare`` inside
    nothing) are listed by what they span."""
    from repro_torch.flashsim import engine_batched as EB
    from repro_torch.flashsim import ftl as FTL
    from repro_torch.flashsim import ssd
    from repro_torch.kernels.fcfs_core import ops as K

    spans = [("trace", ssd, "resolve_trace"), ("trace", ssd, "expand_trace"),
             ("build_ftl_schedule", FTL, "build_ftl_schedule"),
             ("simulators", ssd.SSDSim, "__init__"),
             ("_prepare", ssd.SSDSim, "_prepare"),
             ("_lane_tables", EB, "_lane_tables"), ("pad_ops", K, "pad_ops"),
             ("step and ring bounds", K, "count_steps"),
             ("step and ring bounds", K, "ring_caps"),
             ("dispatch (augment, copies, launch, wait)", K, "_dispatch"),
             ("augment_ops (in dispatch)", K, "augment_ops"),
             ("_assemble_result", EB, "_assemble_result"),
             ("_finalize", ssd.SSDSim, "_finalize")]
    secs = {name: 0.0 for name, _, _ in spans}
    saved = []

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                secs[name] += time.perf_counter() - t0
        return run

    for name, owner, attr in spans:
        fn = owner.__dict__[attr]
        saved.append((owner, attr, fn))
        setattr(owner, attr, timed(name, fn))

    def restore():
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    return secs, restore


@phase("main path")
def main_path_phase(chain_ns):
    import math

    import torch

    from repro_torch.flashsim import OperatingCondition, compare_mechanisms
    from repro_torch.kernels.fcfs_core import ops as K

    cond = OperatingCondition(*CONDITION)
    # Keep every launch's card inputs and outputs, to hold each against
    # the plain version once the main path's counts are read.
    recorded = []
    fwd = K.fcfs_core_fwd

    def recording_fwd(ops, timing, steps, **kw):
        out = fwd(ops, timing, steps, **kw)
        recorded.append((ops, timing, steps, kw, out))
        return out

    K.fcfs_core_fwd = recording_fwd
    secs, restore = _host_timers()
    K.launches = K.smem_launches = 0
    t0 = time.perf_counter()
    res = compare_mechanisms(WORKLOAD, cond, MECHANISMS,
                             n_requests=N_REQUESTS, engine="batched",
                             device=DEVICE)
    torch.cuda.synchronize()
    batched_s = time.perf_counter() - t0
    launches, smem_launches = K.launches, K.smem_launches
    restore()
    K.fcfs_core_fwd = fwd
    if launches <= 0:
        raise AssertionError("compare_mechanisms(engine='batched') never "
                             "launched the fcfs_core kernel")
    if smem_launches != launches:
        raise AssertionError(f"{launches - smem_launches} of {launches} "
                             f"main-path launches ran from global memory")
    if len(recorded) != launches:
        raise AssertionError(f"{len(recorded)} recorded calls for "
                             f"{launches} kernel launches")
    kw0 = recorded[0][3]
    resident = K.resident_lanes(recorded[0][0].shape[1], kw0["n_dies"],
                                kw0["capq"], kw0["capw"], kw0["prio"],
                                DEVICE)
    print(f"main path: {launches} kernel launches ({smem_launches} from "
          f"shared memory) for {len(MECHANISMS)} mechanisms x 8 lanes; "
          f"the card holds {resident} lanes at once at this footprint",
          flush=True)
    top = sum(v for k, v in secs.items() if "(in dispatch)" not in k)
    print(f"host phases of the batched run ({batched_s:.4f} s on the host "
          f"clock, synchronized): " + ", ".join(
              f"{k} {v:.4f} s" for k, v in secs.items())
          + f", rest {batched_s - top:.4f} s", flush=True)

    t0 = time.perf_counter()
    ref = compare_mechanisms(WORKLOAD, cond, ("baseline", "pr2ar2"),
                             n_requests=N_REQUESTS, engine="array",
                             device=DEVICE)
    array_s = time.perf_counter() - t0
    for m in ref:
        if _outcome(res[m]) != _outcome(ref[m]):
            raise AssertionError(f"{m}: batched SimStats differ from the "
                                 f"array interpreter's")
    t0 = time.perf_counter()
    unfused = compare_mechanisms(WORKLOAD, cond, MECHANISMS,
                                 n_requests=N_REQUESTS, engine="batched",
                                 fuse=False, device=DEVICE)
    torch.cuda.synchronize()
    unfused_s = time.perf_counter() - t0
    for m in MECHANISMS:
        if _outcome(res[m]) != _outcome(unfused[m]):
            raise AssertionError(f"{m}: fused SimStats differ from the "
                                 f"unfused run's")
    for m, s in res.items():
        if s.n_requests != N_REQUESTS or not all(
                math.isfinite(v) for v in (s.mean_us, s.p99_us)):
            raise AssertionError(f"{m}: bad stats {s}")
        if s.fast_path_events <= 0:
            raise AssertionError(f"{m}: no events went through the kernel")
        print(f"{m:>12}: mean {s.mean_us:.3f} us  p99 {s.p99_us:.3f} us  "
              f"attempts {s.mean_read_attempts:.3f}  fused_cells "
              f"{s.fused_cells}")
    b, p = res["baseline"], res["pr2ar2"]
    red_mean = 1.0 - p.mean_us / b.mean_us
    red_p99 = 1.0 - p.p99_us / b.p99_us
    if not red_mean > 0.0:
        raise AssertionError("pr2ar2 is not faster than baseline")
    print(f"pr2ar2 vs baseline: mean -{red_mean:.2%}, p99 -{red_p99:.2%}")
    print(f"main path: batched {batched_s:.3f} s ({launches} kernel "
          f"launches), unfused {unfused_s:.3f} s ({len(MECHANISMS)} "
          f"launches), array interpreter for 2 mechanisms {array_s:.3f} s; "
          f"batched == array for baseline and pr2ar2, fused == unfused "
          f"for all six", flush=True)

    held = []
    for i, (ops, timing, steps, kw, out) in enumerate(recorded):
        mode = "prio" if kw["prio"] else "fifo"
        r = _hold(f"main-path launch {i} ({mode}, "
                  f"{int((timing[:, 3] != 0).sum())} of {ops.shape[0]} "
                  f"lanes pipelined)", ops, timing, steps, kw, got=out)
        r["chain_ms"] = r["longest"] * chain_ns * 1e-6
        print(f"  chain bound {r['chain_ms']:.3f} ms = {r['longest']} steps "
              f"x {chain_ns:.3f} ns; kernel at "
              f"{r['ms'] / r['chain_ms']:.1f}x its chain bound", flush=True)
        held.append(r)
    return launches, smem_launches, held


@phase("wide channels")
def wide_phase(chain_ns):
    """The main path's cell on 8 channels of WIDE_CELL_DIES dies through
    ``engine="auto"``: it must select the batched engine with no fallback
    reason, as the reference does, and every launch is held against the
    plain version on the inputs it had (over its first GC_HOLD_STEPS
    steps where a launch is longer)."""
    import dataclasses

    import torch

    from repro_torch.flashsim import (DEFAULT_SSD, OperatingCondition,
                                      compare_mechanisms)
    from repro_torch.kernels.fcfs_core import ops as K

    cfg = dataclasses.replace(DEFAULT_SSD, dies_per_channel=WIDE_CELL_DIES)
    recorded = []
    fwd = K.fcfs_core_fwd

    def recording_fwd(ops, timing, steps, **kw):
        out = fwd(ops, timing, steps, **kw)
        recorded.append((ops, timing, steps, kw, out))
        return out

    K.fcfs_core_fwd = recording_fwd
    K.launches = K.smem_launches = 0
    t0 = time.perf_counter()
    try:
        res = compare_mechanisms(WORKLOAD, OperatingCondition(*CONDITION),
                                 MECHANISMS, cfg=cfg, n_requests=N_REQUESTS,
                                 engine="auto", device=DEVICE)
        torch.cuda.synchronize()
    finally:
        K.fcfs_core_fwd = fwd
    wide_s = time.perf_counter() - t0
    launches, smem_launches = K.launches, K.smem_launches
    if launches <= 0 or len(recorded) != launches:
        raise AssertionError(f"wide cell: {launches} kernel launches, "
                             f"{len(recorded)} recorded calls")
    for m, st in res.items():
        if st.engine_selected != "batched" or st.engine_fallback_reason:
            raise AssertionError(
                f"{m}: engine='auto' selected {st.engine_selected!r} "
                f"({st.engine_fallback_reason!r}) on {WIDE_CELL_DIES} dies "
                f"a channel")
        if st.n_requests != N_REQUESTS or st.fast_path_events <= 0 or \
                not all(math.isfinite(v) for v in (st.mean_us, st.p99_us)):
            raise AssertionError(f"{m}: bad stats {st}")
        print(f"{m:>12}: mean {st.mean_us:.3f} us  p99 {st.p99_us:.3f} us  "
              f"attempts {st.mean_read_attempts:.3f}  fused_cells "
              f"{st.fused_cells}")
    if not res["pr2ar2"].mean_us < res["baseline"].mean_us:
        raise AssertionError("wide cell: pr2ar2 is not faster than baseline")
    ops0, _, _, kw0, _ = recorded[0]
    variant, smem = _variant(ops0, kw0)
    resident = K.resident_lanes(ops0.shape[1], kw0["n_dies"], kw0["capq"],
                                kw0["capw"], kw0["prio"], DEVICE)
    print(f"wide cell: {cfg.n_channels} channels x {WIDE_CELL_DIES} dies, "
          f"engine 'batched' (auto, no fallback) for all "
          f"{len(MECHANISMS)} mechanisms in {wide_s:.3f} s; {launches} "
          f"kernel launch(es), {smem_launches} from shared memory "
          f"(placement {variant}, {smem} B a block, "
          f"{K.static_smem_bytes(kw0['n_dies'])} B of die state), "
          f"{ops0.shape[0]} lanes of {kw0['n_dies']} dies, capq "
          f"{kw0['capq']}; the card holds {resident} lanes at once at "
          f"this footprint", flush=True)
    held = []
    for i, (ops, timing, steps, kw, out) in enumerate(recorded):
        r = _hold(f"wide-cell launch {i} ({ops.shape[0]} lanes of "
                  f"{kw['n_dies']} dies)", ops, timing, steps, kw, got=out,
                  plain_steps=GC_HOLD_STEPS)
        r["chain_ms"] = r["longest"] * chain_ns * 1e-6
        print(f"  chain bound {r['chain_ms']:.3f} ms = {r['longest']} steps "
              f"x {chain_ns:.3f} ns; kernel at "
              f"{r['ms'] / r['chain_ms']:.1f}x its chain bound", flush=True)
        held.append(r)
    return launches, smem_launches, held


# -- serving: the flash-attention and KV retry kernels ----------------------


def _fa_bound_ms(q, k, v, out, kw):
    """Bytes (each input read once, the output written once) and the
    operations the visible (query, key) pairs need — 2 flops per
    element of q.k and of p.v — over the peak of the inputs' type, in
    milliseconds."""
    from repro_torch.kernels.flash_attention.plain import attention_mask

    BH, T, hd = q.shape
    S = k.shape[1]
    pairs = int(attention_mask(T, S, kw.get("causal", True), kw.get("window"),
                               kw.get("kv_valid"), q.device,
                               kw.get("q_offset", 0)).sum())
    n_ops = 4.0 * BH * pairs * hd
    peak = BF16_OPS_PER_S if q.dtype.itemsize == 2 else F32_OPS_PER_S
    n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    return n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / peak * 1e3


def _sdpa_ms(q, k, v, kw, reps):
    """``scaled_dot_product_attention`` on the same inputs (kernel layout
    viewed as (BK, G, T, hd) queries over (BK, 1, S, hd) keys; a window
    or ``kv_valid`` that hides keys beyond the causal mask as a boolean
    mask built outside the timed call, else ``is_causal``, which keeps
    the flash backend), or None where it does not compute the same
    function (softcap)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.plain import attention_mask

    if kw.get("softcap") is not None:
        return None, None
    BH, T, hd = q.shape
    BK, S, _ = k.shape
    qq = q.view(BK, BH // BK, T, hd)
    kk, vv = k.view(BK, 1, S, hd), v.view(BK, 1, S, hd)
    causal = kw.get("causal", True)
    mask = None
    if kw.get("window") is not None or kw.get("kv_valid") is not None:
        mask = attention_mask(T, S, causal, kw.get("window"),
                              kw.get("kv_valid"), q.device)
        if torch.equal(mask, attention_mask(T, S, causal, None, None,
                                            q.device)):
            mask = None

    def call():
        if mask is None:
            return F.scaled_dot_product_attention(
                qq, kk, vv, is_causal=causal, enable_gqa=True)
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                              enable_gqa=True)

    call()
    ms, out = _cuda_ms(call, reps)
    return ms, out.reshape(BH, T, hd)


def _hold_fa(name, q, k, v, kw, got=None, reps=3, library=True, quiet=False):
    """Hold one flash-attention launch against the plain version on the
    same card tensors and time kernel, plain version and library call."""
    import torch

    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.plain import (
        bf16_err_ratio, flash_attention_plain)

    FA.flash_attention_fwd(q, k, v, **kw)                # warm-up
    ms, again = _cuda_ms(lambda: FA.flash_attention_fwd(q, k, v, **kw), reps)
    got = again if got is None else got
    plain_ms, want = _cuda_ms(lambda: flash_attention_plain(q, k, v, **kw), 1)
    err = float((got.float() - want.float()).abs().max())
    # Worst |err| / tolerance: 1e-5 in float32; element by element in
    # bfloat16 (one ulp of the plain value plus 2^-8 of the row's rms).
    ratio = err / FA_F32_TOL if q.dtype.itemsize == 4 else \
        bf16_err_ratio(got, want)
    if not ratio <= 1.0 or not torch.equal(got, again):
        raise AssertionError(f"{name}: flash_attention differs from its plain "
                             f"version (max abs {err}, worst |err| / "
                             f"tolerance {ratio}) or is not deterministic")
    lib_ms, lib_out = _sdpa_ms(q, k, v, kw, reps) if library else (None, None)
    t_bytes, t_ops = _fa_bound_ms(q, k, v, got, kw)
    bound_ms, bound_by = _bound(t_bytes, t_ops)
    lib = "none" if lib_ms is None else (
        f"{lib_ms:.3f} ms (max abs vs plain "
        f"{float((lib_out.float() - want.float()).abs().max()):.3g})")
    peak = BF16_OPS_PER_S if q.dtype.itemsize == 2 else F32_OPS_PER_S
    if not quiet:
        print(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} "
              f"{kw} max_abs_err {err:.3g} (worst |err| / tolerance "
              f"{ratio:.3g}) kernel {ms:.4f} ms, "
              f"{t_ops * 1e-3 * peak / ms / 1e9:.1f} TFLOP/s of the "
              f"reference's operations, plain {plain_ms:.3f} ms bound "
              f"{bound_ms:.4f} ms ({bound_by}; kernel at "
              f"{t_ops / ms * 100:.1f}% of the operations bound) sdpa {lib}",
              flush=True)
    return dict(case=name, ms=ms, plain_ms=plain_ms, t_bytes=t_bytes,
                t_ops=t_ops, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms, max_abs_err=err, tol_ratio=ratio,
                causal=kw.get("causal", True), T=q.shape[1], S=k.shape[1])


def _check_controls(q, k, v):
    """The bfloat16 rule must reject both faulty variants on the causal
    prefill case; returns their worst |err| / tolerance."""
    from repro_torch.kernels.flash_attention.plain import (
        bf16_err_ratio, faulty_attention_plain, flash_attention_plain)

    want = flash_attention_plain(q, k, v, causal=True)
    out = {}
    for fault in ("p-bf16", "drop-tile"):
        out[fault] = bf16_err_ratio(faulty_attention_plain(q, k, v, fault),
                                    want)
        print(f"control {fault}: worst |err| / tolerance {out[fault]:.3g} "
              f"(must exceed 1)", flush=True)
        if not out[fault] > 1.0:
            raise AssertionError(f"the bfloat16 rule accepts the {fault} "
                                 f"control ({out[fault]})")
    return out


def _kv_bound_ms(data_q, scale, backing, out, margin):
    """Bytes the read must move — the int8 pages and scales, the output
    and margins, and the backing pages only of the pages that retry —
    and its float32 operations (dequant, square, sum: 3 a value, and 5 a
    page), in milliseconds."""
    P, E = data_q.shape
    retried = int((margin[:, 0] < 0).sum())
    n_bytes = (data_q.numel() + 4 * scale.numel() + 4 * margin.numel()
               + out.numel() * out.element_size()
               + retried * E * backing.element_size())
    n_ops = 3.0 * P * E + 5.0 * P
    return n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3, \
        retried


def _hold_kv(name, data_q, scale, backing, tau, got=None, reps=3,
             quiet=False):
    """Hold one KV retry launch against the plain version on the same
    card tensors: margins within rtol 1e-6 of the larger of the margin
    and its ratio term, decisions counted, outputs bit for bit where
    decisions agree.  A decision may differ from the plain version's
    (a flip) only where the vector kernel took it: its margins and
    outputs must then equal, bit for bit, ``kv_retry_emulate`` on the
    card (the plain formula in the kernel's summation order), so a flip
    is a page whose margin lies within the rtol of 0, where the two sum
    orders round to opposite signs; any other launch must have 0
    flips.  On int8 backing (the in-model int8 cache's pages: amax 127,
    scale 1, or all zero, so every sum of squares is an integer below
    2^24, exact in any order) outputs and margins must equal the plain
    version's bit for bit, with no flip."""
    import torch

    from repro_torch.kernels.kv_retry import ops as KV
    from repro_torch.kernels.kv_retry.emulate import kv_retry_emulate
    from repro_torch.kernels.kv_retry.plain import kv_retry_plain

    KV.kv_retry_fwd(data_q, scale, backing, tau)          # warm-up
    ms, again = _cuda_ms(lambda: KV.kv_retry_fwd(data_q, scale, backing, tau),
                         reps)
    out, margin = again if got is None else got
    plain_ms, (want, want_m) = _cuda_ms(
        lambda: kv_retry_plain(data_q, scale, backing, tau), 1)
    m, w = margin.double(), want_m.double()
    gap = float(((m - w).abs() / torch.maximum(w.abs(), (1 - w).abs())).max())
    fast = margin[:, 0] >= 0
    flips = int((fast != (want_m[:, 0] >= 0)).sum())
    agree = fast == (want_m[:, 0] >= 0)
    err = float((out[agree].float() - want[agree].float()).abs().max()) \
        if bool(agree.any()) else 0.0
    own_order = True
    if flips:
        own_order = KV.uses_vector(data_q.shape[1])
        if own_order:
            emu, emu_m = kv_retry_emulate(data_q, scale, backing, tau)
            own_order = torch.equal(margin, emu_m) and torch.equal(out, emu)
            del emu, emu_m
    int8 = backing.dtype == torch.int8
    if int8 and not (torch.equal(out, want) and torch.equal(margin, want_m)):
        raise AssertionError(f"{name}: kv_retry on int8 backing differs "
                             f"from its plain version: {flips} flips, "
                             f"margin gap {gap:.3g}, max abs {err}")
    if gap > KV_MARGIN_RTOL or not own_order or err != 0.0 or not (
            torch.equal(out, again[0]) and torch.equal(margin, again[1])):
        raise AssertionError(f"{name}: kv_retry differs from its plain "
                             f"version: margin gap {gap:.3g}, {flips} "
                             f"flips (equal to its own order's emulation: "
                             f"{own_order}), max abs {err}")
    t_bytes, t_ops, retried = _kv_bound_ms(data_q, scale, backing, out, margin)
    bound_ms, bound_by = _bound(t_bytes, t_ops)
    P, E = data_q.shape
    if not quiet:
        print(f"{name}: {P} pages of {E} {backing.dtype}, tau {tau}: "
              f"{P - retried} fast, {retried} retried; margin gap {gap:.3g} "
              f"(rtol {KV_MARGIN_RTOL}), {flips} flips, max_abs_err {err} "
              f"kernel "
              f"{ms:.3f} ms plain {plain_ms:.3f} ms bound {bound_ms:.4f} ms "
              f"({bound_by}; kernel at {t_bytes / ms * 100:.1f}% of the "
              f"bytes bound)", flush=True)
    return dict(case=name, ms=ms, plain_ms=plain_ms, t_bytes=t_bytes,
                t_ops=t_ops, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=err, pages=P, retried=retried, flips=flips,
                moved=t_bytes * HBM_BYTES_PER_S * 1e-3,
                leaf=backing.numel() * backing.element_size(), int8=int8)


def _kv_leaf_report(held, data_q, scale, backing, tau):
    """The decode leaf's variant and share of its bytes bound, the
    warp-per-page kernel (the first design) on the same leaf, and
    ``quantize_pages`` of the leaf, which the KV store runs on every leaf
    at every step (a measurement beside B3, not a kernel of the port)."""
    from repro_torch.kernels.kv_retry import ops as KV
    from repro_torch.kernels.kv_retry.emulate import lanes_per_page
    from repro_torch.kernels.kv_retry.plain import quantize_pages

    E = data_q.shape[1]
    if not KV.uses_vector(E):
        raise AssertionError(f"the decode leaf (E {E}) must take the vector "
                             f"kernel")

    def warp_per_page():
        return KV._launch_cuda(data_q, scale, backing, tau, vector=False)

    warp_per_page()                                       # warm-up
    old_ms, _ = _cuda_ms(warp_per_page, KERNEL_REPS)
    quant_ms, _ = _cuda_ms(lambda: quantize_pages(backing), KERNEL_REPS)
    t = held["t_bytes"]
    print(f"decode leaf: vector kernel ({lanes_per_page(E)} lanes a page) "
          f"{held['ms']:.4f} ms, "
          f"{t / held['ms'] * 100:.1f}% of the {t:.4f} ms bytes bound; "
          f"warp-per-page kernel {old_ms:.4f} ms, "
          f"{t / old_ms * 100:.1f}%; quantize_pages of the leaf "
          f"{quant_ms:.4f} ms", flush=True)


def _hgmma_counts(source, marker, n_tc):
    """HGMMA (wgmma) instructions in the SASS of each kernel instance of
    ``source``, by ``cuobjdump -sass`` on the built library; the
    ``n_tc`` instances whose name holds ``marker`` (the bfloat16
    tensor-core ones) must hold some, every other instance none."""
    from repro_torch.kernels import build

    counts = {fn: sum("HGMMA" in i for i in ins)
              for fn, ins in build.sass(source).items()}
    for fn, n in counts.items():
        print(f"HGMMA instructions in {fn}: {n}")
        if (marker in fn) != (n > 0):
            raise AssertionError(f"{fn}: {n} HGMMA instructions")
    if sum(marker in fn for fn in counts) != n_tc:
        raise AssertionError(f"tensor-core instances missing: {counts}")
    return counts


@phase("serve kernels")
def serve_kernel_phase():
    import torch

    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.kv_retry.emulate import pages_near_zero
    from repro_torch.kernels.kv_retry.plain import quantize_pages

    _hgmma_counts(FA._SOURCE, "fa_tc_kernel",
                  sum(FA.uses_tensor_cores(torch.bfloat16, hd)
                      for hd in FA.HEAD_DIMS))

    gen = torch.Generator(DEVICE).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=DEVICE)
                ).to(torch.bfloat16)

    B, T, H, K, hd = PREFILL_SHAPE
    cases = [
        ("llama prefill, causal", (B * H, B * K, T, hd),
         dict(causal=True)),
        ("llama prefill shape at hd 64, causal", (B * H, B * K, T, 64),
         dict(causal=True)),
        (f"window {T // 4} + softcap 50, hd 256", (B * 8, B * 4, T, 256),
         dict(causal=True, window=T // 4, softcap=50.0)),
        (f"kv_valid {T * 3 // 4 - 36}, non-causal", (B * H, B * K, T, hd),
         dict(causal=False, kv_valid=T * 3 // 4 - 36)),
    ]
    fa, controls, cp = [], None, []
    for i, (name, (bh, bk, t, d), kw) in enumerate(cases):
        q, k, v = randn(bh, t, d), randn(bk, t, d), randn(bk, t, d)
        fa.append(_hold_fa(name, q, k, v, kw))
        if controls is None:
            controls = _check_controls(q, k, v)
        if i in (0, 2):     # llama3.2-3b's prefill; gemma2-2b's window
            cp += _cp_shards(name, q, k, v, kw)
        del q, k, v
    torch.cuda.empty_cache()

    # One full-width decode leaf: (U, B, K, S, hd) pages; about a third
    # of the pages carry one large value, so that they retry.
    P = 28 * B * K * T
    backing = randn(P, hd)
    spiky = torch.rand(P, generator=gen, device=DEVICE) < 0.3
    col = torch.randint(0, hd, (P,), generator=gen, device=DEVICE)
    backing[spiky, col[spiky]] *= 40.0
    data_q, scale = quantize_pages(backing)
    kv = [_hold_kv(f"decode leaf (28, {B}, {K}, {T}, {hd})", data_q, scale,
                   backing, LEAF_TAU)]
    _kv_leaf_report(kv[0], data_q, scale, backing, LEAF_TAU)
    del backing, data_q, scale
    q, s, tau = pages_near_zero(1 << 16, hd)
    kv.append(_hold_kv(f"near-zero margins ({q.shape[0]} pages of {hd}, "
                       f"exact sums)", q.to(DEVICE), s.to(DEVICE),
                       randn(*q.shape), tau))
    torch.cuda.empty_cache()
    return fa, kv, controls, cp


#: The context-parallel check's query shards ("model" 4).
CP_SHARDS = 4


def _cp_shards(name, q, k, v, kw):
    """Context-parallel B4 (ROADMAP D15c-2b): the queries of one prefill
    case split into ``CP_SHARDS`` shards at offsets 0, T/4, T/2 and 3T/4,
    each launched against every key with ``q_offset`` and held against
    the plain version at that offset; the shards' outputs concatenated
    equal the unsplit launch bit for bit.  Returns the shards' held
    records."""
    import torch

    from repro_torch.kernels.flash_attention import ops as FA

    t0 = time.perf_counter()
    T = q.shape[1]
    n = T // CP_SHARDS
    whole = FA.flash_attention_fwd(q, k, v, **kw)
    held, outs = [], []
    for i in range(CP_SHARDS):
        qs = q[:, i * n:(i + 1) * n].contiguous()
        kwi = dict(kw, q_offset=i * n)
        outs.append(FA.flash_attention_fwd(qs, k, v, **kwi))
        held.append(_hold_fa(f"{name} shard {i}", qs, k, v, kwi,
                             got=outs[-1], library=False, quiet=True))
    cat = torch.cat(outs, dim=1)
    if not torch.equal(cat, whole):
        raise AssertionError(f"{name}: the {CP_SHARDS} query shards' B4 "
                             f"outputs differ from the unsplit launch (max "
                             f"abs {float((cat - whole).float().abs().max())})")
    _print_held(f"  {name}, {CP_SHARDS} query shards (q_offset "
                f"{[i * n for i in range(CP_SHARDS)]}; concatenated equal "
                f"to the unsplit launch bit for bit; "
                f"{time.perf_counter() - t0:.3f} s)", held)
    return held


def _routing_flips(arch, calls, k):
    """Compare the MoE router's picks of the card's calls with the CPU's
    (``calls``: the recorded ``route`` calls of both, in order); print
    each token whose picks differ with its k-th and (k+1)-th CPU
    probabilities and their gap.  Returns (tokens compared, flips)."""
    import torch

    card = [out for _, out in calls if out[0].device.type == "cuda"]
    cpu = [out for _, out in calls if out[0].device.type == "cpu"]
    if len(card) != len(cpu):
        raise AssertionError(f"{arch}: {len(card)} router calls on the card, "
                             f"{len(cpu)} on the CPU")
    n = flips = 0
    for (_, _, ic), (pp, _, ip) in zip(card, cpu):
        n += ip.shape[0]
        for row in (ic.cpu() != ip).any(dim=-1).nonzero()[:, 0].tolist():
            flips += 1
            top = torch.sort(pp[row], descending=True).values
            nxt = float(top[k]) if k < top.numel() else float("nan")
            print(f"  {arch} routing flip at token row {row}: card "
                  f"{ic[row].tolist()} cpu {ip[row].tolist()}; k-th "
                  f"probability {float(top[k - 1]):.9g}, (k+1)-th {nxt:.9g}, "
                  f"gap {float(top[k - 1]) - nxt:.3g}", flush=True)
    return n, flips


def _small_width_check(arch, min_agree, exact=False, **overrides):
    """The serve path on the card against itself on the CPU (where the
    kernels run their plain versions), at the reduced width of ``arch``
    in float32 (with ``overrides``), with the same weights: prefill and
    two decode steps' logits within 1e-4 of the largest, and the served
    tokens and KV read stats of 8 new tokens compared (at least
    ``min_agree`` of the tokens equal, and equal page counts; ``exact``:
    equal tokens and equal stats).  The VLM's prefill takes seeded random
    patch embeddings and the encoder-decoder's seeded random frame
    embeddings (the engine feeds zeros).  For MoE configs each router
    call's picks are compared too, and a token whose picks differ is
    printed with its probabilities.  An int8 KV cache (``REPRO_KV_INT8=1``,
    whose data the two devices may round to adjacent levels where a K/V
    value sits at a rounding boundary): the CPU decodes from the card's
    cache, so the logits compare the same step on the same inputs, and
    the caches are held apart: float leaves within 1e-4 of their
    largest, int8 leaves at most one level apart on at most 1e-3 of
    their elements (the differing ones counted)."""
    import contextlib
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.retry import RetryPolicy
    from repro_torch.launch.serve import default_prompts
    from repro_torch.models import moe as MOE
    from repro_torch.models.api import frontend_zeros
    from repro_torch.optim.adamw import tree_map
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.kv_store import _leaves

    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              activation_dtype="float32", **overrides)
    # Prompts up to 40 tokens: past gemma2's reduced window of 32, and
    # over two of mamba2's reduced chunks of 32.
    rng = np.random.default_rng(5)
    prompts = default_prompts(cfg.vocab, 4)[:2] + [
        rng.integers(2, cfg.vocab, size=n).astype(np.int32) for n in (40, 33)]
    card = ServeEngine(cfg, policy=RetryPolicy("pr2ar2"), tau=0.01, seed=0,
                       device=DEVICE)
    cpu = ServeEngine(cfg, params=tree_map(lambda t: t.to("cpu"),
                                           card.params),
                      policy=RetryPolicy("pr2ar2"), tau=0.01, device="cpu")
    toks = torch.as_tensor(card._pad_batch(prompts))
    front = {k: torch.as_tensor(rng.standard_normal(tuple(v.shape)),
                                dtype=torch.float32)
             for k, v in frontend_zeros(cfg, len(prompts), "cpu").items()}
    pos0 = toks.shape[1] + (cfg.n_patches if cfg.family == "vlm" else 0)
    gap, apart, steps = 0.0, 0, []
    routes = _Recorder(MOE, "route") if cfg.moe is not None else \
        contextlib.nullcontext()
    with torch.inference_mode(), routes:
        outs = [e.model.prefill(e.params, {
            k: v.to(e.device) for k, v in dict(tokens=toks, **front).items()})
            for e in (card, cpu)]
        int8 = any(leaf.dtype == torch.int8 for _, leaf in _leaves(outs[0][1]))
        for step in range(3):
            (lc, cc), (lp, cp) = outs
            lc = lc.cpu()
            if not bool(torch.isfinite(lc).all()):
                raise AssertionError(f"{arch}: non-finite logits")
            steps.append(float((lc - lp).abs().max() / lp.abs().max()))
            gap = max(gap, steps[-1])
            if step == 2:
                break
            tok = lp[:, -1].argmax(-1)[:, None]
            if int8:
                apart += _int8_cache_gap(arch, cc, cp)
                cp = tree_map(lambda t: t.to("cpu"), cc)
            outs = [e.model.decode_step(e.params, {
                "token": tok.to(e.device), "pos": pos0 + step,
                "cache": c}) for e, c in ((card, cc), (cpu, cp))]
    routing = ""
    if cfg.moe is not None:
        n, flips = _routing_flips(arch, routes.calls, cfg.moe.top_k)
        routing = f"; router picks of {n} tokens, {flips} differ"
    if gap > 1e-4:
        raise AssertionError(f"{arch} small width: card logits differ from "
                             f"the CPU's by {gap:.3g} of the largest "
                             f"(prefill and decode steps {steps}; int8 "
                             f"elements apart {apart}){routing}")
    g_card, s_card = card.generate(prompts, max_new_tokens=8)
    g_cpu, s_cpu = cpu.generate(prompts, max_new_tokens=8)
    agree = float((g_card == g_cpu).mean())
    shared = f"; {apart} int8 cache elements a level apart, decode from " \
        f"the card's cache, gaps by step {steps}" if int8 else ""
    print(f"small-width {arch} ({overrides or 'reduced'}, float32, tau "
          f"0.01): logits gap {gap:.3g} of the largest (prefill, 2 decode "
          f"steps{routing}{shared}); served tokens card == cpu {agree:.4f}; "
          f"kv_fast card "
          f"{100 * s_card.kv.fast_fraction:.2f}% cpu "
          f"{100 * s_cpu.kv.fast_fraction:.2f}% of {s_card.kv.pages} pages",
          flush=True)
    if agree < min_agree or s_card.kv.pages != s_cpu.kv.pages or (
            exact and s_card.kv != s_cpu.kv):
        raise AssertionError(f"{arch} small width: served tokens "
                             f"{g_card.tolist()} vs {g_cpu.tolist()}, KV "
                             f"stats {s_card.kv} vs {s_cpu.kv}")


def _int8_cache_gap(arch, card, cpu):
    """Hold a cache of the card against the CPU's: float leaves within
    1e-4 of their largest, int8 leaves at most one level apart on at most
    1e-3 of their elements; returns the count of int8 elements apart."""
    import torch

    from repro_torch.serving.kv_store import _leaves, keystr

    apart = 0
    for (path, a), (_, b) in zip(_leaves(card), _leaves(cpu)):
        a = a.cpu()
        if a.dtype == b.dtype == torch.int8:
            d = (a.int() - b.int()).abs()
            n = int((d > 0).sum())
            if int(d.max()) > 1 or n > 1e-3 * d.numel():
                raise AssertionError(f"{arch} {keystr(path)}: {n} int8 "
                                     f"elements apart, up to {int(d.max())}")
            apart += n
        elif float((a.float() - b.float()).abs().max()) > \
                1e-4 * float(b.float().abs().max()):
            raise AssertionError(f"{arch} {keystr(path)}: card and CPU "
                                 f"caches differ")
    return apart


def _request_sets(vocab, long_lengths=LONG_LENGTHS):
    import numpy as np

    from repro_torch.launch.serve import default_prompts

    rng = np.random.default_rng(1)
    long = [rng.integers(2, vocab, size=n).astype(np.int32)
            for n in long_lengths]
    return (("short", default_prompts(vocab, 4)), ("long", long))


def _kernel_modules():
    """The launch-counting wrapper module of every kernel of the port."""
    from repro_torch.kernels.fcfs_core import ops as fcfs
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.kv_retry import ops as kv
    from repro_torch.kernels.rber import ops as rber
    from repro_torch.kernels.ssd_scan import ops as ssd

    return {"fcfs_core": fcfs, "flash_attention": fa, "kv_retry": kv,
            "ssd_scan": ssd, "rber": rber}


#: Every serve-path launch of these kernels must take the named variant:
#: ``{count key: (the wrapper's counter, the variant)}``.
_VARIANTS = {
    "flash_attention_tc": ("tc_launches", "on the tensor cores"),
    "ssd_scan_tc": ("tc_launches", "on the tensor cores"),
    "kv_retry_vec": ("vec_launches", "through the vector kernel"),
}


#: The wrapper each serve-path kernel is entered through, and how one
#: recorded launch (its bound arguments and its output) is held.
_HOLDERS = {
    "flash_attention": ("flash_attention_fwd", lambda name, a, out: _hold_fa(
        name, a.pop("q"), a.pop("k"), a.pop("v"), a, got=out, quiet=True)),
    "kv_retry": ("kv_retry_fwd", lambda name, a, out: _hold_kv(
        name, a["data_q"], a["scale"], a["backing"], a["tau"], got=out,
        quiet=True)),
    "ssd_scan": ("ssd_scan_fwd", lambda name, a, out: _hold_ssd(
        name, (a["x"], a["Bm"], a["Cm"], a["dt"], a["dA"]), a["chunk"],
        got=out, quiet=True)),
}


class _Recorder:
    """Wraps ``module.<name>`` while entered, counting its calls (``n``)
    and keeping each call's bound arguments and output (``calls``; with
    ``keep``, only the calls whose index it accepts), so that the
    launches of a main-path run can be held against the plain version
    afterwards."""

    def __init__(self, module, name, keep=None):
        import inspect

        self.module, self.name, self.keep = module, name, keep
        self.orig = getattr(module, name)
        self.sig = inspect.signature(self.orig)
        self.calls = []
        self.n = 0

    def __enter__(self):
        def record(*a, **kw):
            out = self.orig(*a, **kw)
            self.n += 1
            if self.keep is not None and not self.keep(self.n - 1):
                return out
            bound = self.sig.bind(*a, **kw)
            bound.apply_defaults()
            self.calls.append((dict(bound.arguments), out))
            return out

        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _finite_checked(engines):
    """Wrap each engine's prefill and decode step to note whether all its
    logits are finite; returns the list the notes go to."""
    import dataclasses

    import torch

    finite = []

    def checked(fn):
        def run(params, batch):
            logits, cache = fn(params, batch)
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        return run

    for e in engines.values():
        e.model = dataclasses.replace(
            e.model, prefill=checked(e.model.prefill),
            decode_step=checked(e.model.decode_step))
    return finite


def _drive(runs, kernels, finite, keep=None, variants=None):
    """Serve each run ``(label, engine, prompts)`` with every kernel's
    launch count set to 0 just before and read just after, recording the
    launches of ``kernels`` (``keep``: {kernel: which launch indices of a
    run to keep}, the others counted only); then hold each recorded
    launch against the plain version on its inputs, and time it beside
    its bound.  ``variants`` (default ``_VARIANTS``) names the variant
    every launch of a kernel must take.  Returns ({kernel: launches over
    the runs}, {kernel: held launches}, {label: (tokens, ServeStats,
    launch counts)})."""
    import contextlib

    import torch

    from repro_torch.serving import KVReadStats

    mods = _kernel_modules()
    variants = _VARIANTS if variants is None else variants
    launches = dict.fromkeys((*mods, *variants), 0)
    held = {k: [] for k in kernels}
    out = {}
    for label, e, prompts in runs:
        e.store.stats = KVReadStats()
        finite.clear()
        for m in mods.values():
            m.launches = 0
        for k, (attr, _) in variants.items():
            setattr(mods[k.rsplit("_", 1)[0]], attr, 0)
        recs = {k: _Recorder(mods[k], _HOLDERS[k][0],
                             (keep or {}).get(k)) for k in kernels}
        with contextlib.ExitStack() as stack:
            for r in recs.values():
                stack.enter_context(r)
            gen, st = e.generate(prompts, max_new_tokens=SERVE_MAX_NEW)
        counts = {k: m.launches for k, m in mods.items()}
        for k, (attr, what) in variants.items():
            name = k.rsplit("_", 1)[0]
            counts[k] = getattr(mods[name], attr)
            if counts[k] != counts[name]:
                raise AssertionError(f"{label}: {counts[name]} {name} "
                                     f"launches, {counts[k]} of them {what}")
        if any(r.n != counts[k] for k, r in recs.items()):
            raise AssertionError(f"{label}: recorded calls != launches "
                                 f"{counts}")
        if not bool(torch.stack(finite).all()):
            raise AssertionError(f"{label}: non-finite logits")
        for k, n in counts.items():
            launches[k] += n
        out[label] = (gen, st, counts)
        print(f"{label}: {st.summary()}; launches {counts}", flush=True)
        # Hold this run's launches on the inputs they had, then let them
        # go (a long llama run keeps ~40 GB of KV pages).
        for k, r in recs.items():
            rs = [_HOLDERS[k][1](f"{label} launch {i}", a, o)
                  for i, (a, o) in enumerate(r.calls)]
            if rs and r.n != len(rs):
                print(f"  {label} {k}: {len(rs)} of {r.n} launches kept "
                      f"and held, the rest counted", flush=True)
            if rs:
                _print_held(f"  {label} {k}", rs)
            held[k] += rs
        del recs
        torch.cuda.empty_cache()
    return launches, held, out


def _first_leaf_ratio(store):
    """The first KV leaf of a store's cache (in the reference's order),
    its key, and each page's max|v| / rms: a page retries where tau <
    max / (254 rms), since its margin is 1 - 0.5 (max/127) / (tau rms)."""
    import torch

    def first(tree, path=()):
        for k in sorted(tree):
            v, p = tree[k], path + (k,)
            if isinstance(v, dict):
                hit = first(v, p)
                if hit is not None:
                    return hit
            elif "attn" in p and k in ("k", "v"):
                return p, v
        return None

    path, leaf = first(store.backing)
    x = leaf.reshape(-1, leaf.shape[-1]).float()
    ratio = x.abs().amax(dim=-1) / x.square().mean(dim=-1).sqrt()
    return "".join(f"[{k!r}]" for k in path), ratio


def _serve_full_width(arch, prefix="", long_lengths=LONG_LENGTHS,
                      keep=None, kernels=("flash_attention", "kv_retry"),
                      variants=None):
    """``ServeEngine`` for ``arch`` at its published widths with seeded
    weights, as pr2ar2 at SERVE_TAU, baseline, and pr2ar2 at RETRY_TAU,
    driven (``_drive``, which keeps the launches ``keep`` accepts) over
    the short and long (``long_lengths``) request sets and the short set
    at the retrying tau, with run labels starting ``prefix``.  pr2ar2
    must serve some pages fast and baseline none, and the retrying run
    must retry some page reads and serve others fast.  ``kernels`` are
    recorded and held, ``variants`` as ``_drive`` takes them.  Returns
    (engines, parameter count, launches, held launches, runs)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.retry import RetryPolicy
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.serving import ServeEngine

    cfg = get_config(arch)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, policy=RetryPolicy("pr2ar2"), tau=SERVE_TAU,
                      seed=0, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(eng.params))
    print(f"{arch}: {n_params} seeded float32 parameters on the card in "
          f"{time.perf_counter() - t0:.3f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    engines = {
        "pr2ar2": eng,
        "baseline": ServeEngine(cfg, params=eng.params,
                                policy=RetryPolicy("baseline"),
                                tau=SERVE_TAU, device=DEVICE),
        "retry": ServeEngine(cfg, params=eng.params,
                             policy=RetryPolicy("pr2ar2"), tau=RETRY_TAU,
                             device=DEVICE),
    }
    finite = _finite_checked(engines)
    sets = _request_sets(cfg.vocab, long_lengths)
    for e in engines.values():            # warm-up: library loads, cuBLAS
        e.generate(sets[0][1], max_new_tokens=2)
    retry_label = f"{prefix}short pr2ar2 tau {RETRY_TAU}"
    runs = [(f"{prefix}{s} {m}", engines[m], p) for s, p in sets
            for m in ("pr2ar2", "baseline")]
    runs.append((retry_label, engines["retry"], sets[0][1]))
    launches, held, out = _drive(runs, kernels, finite, keep, variants)
    for set_name, _ in sets:
        p_gen, p_st, _ = out[f"{prefix}{set_name} pr2ar2"]
        b_gen, b_st, _ = out[f"{prefix}{set_name} baseline"]
        if not p_st.kv.fast_fraction > 0 or b_st.kv.fast_fraction != 0:
            raise AssertionError(f"{prefix}{set_name}: kv_fast pr2ar2 "
                                 f"{p_st.kv.fast_fraction}, baseline "
                                 f"{b_st.kv.fast_fraction}")
        agree = float((p_gen == b_gen).mean())
        print(f"{prefix}{set_name}: pr2ar2/baseline token agreement "
              f"{agree:.4f} ({int((p_gen == b_gen).sum())} of {p_gen.size})")
    # The retrying run: B3's backing-read branch on the main path.
    r_st = out[retry_label][1]
    if not (r_st.kv.retried_pages > 0 and r_st.kv.fast_pages > 0):
        raise AssertionError(f"{retry_label}: no page retried, or none was "
                             f"fast: {r_st.kv}")
    return engines, n_params, launches, held, out


@phase("serve path")
def serve_path_phase():
    _small_width_check("llama3.2-3b", 0.9, head_dim=64)
    _small_width_check("gemma2-2b", 0.9, head_dim=64)

    engines, _, launches, held, out = _serve_full_width(SERVE_ARCH)
    for name in ("flash_attention", "kv_retry"):
        if launches[name] <= 0:
            raise AssertionError(f"the serve path never launched {name}")
    print(f"flash_attention: {launches['flash_attention']} main-path "
          f"launches, {launches['flash_attention_tc']} of them through the "
          f"tensor-core kernel (tc_launches); kv_retry: "
          f"{launches['kv_retry']}, {launches['kv_retry_vec']} of them "
          f"through the vector kernel (vec_launches)", flush=True)
    retry_label = f"short pr2ar2 tau {RETRY_TAU}"
    r_st = out[retry_label][1]
    key, ratio = _first_leaf_ratio(engines["retry"].store)
    ratio = ratio.sort().values
    q = [float(ratio[int(f * (ratio.numel() - 1))]) for f in (0.1, 0.5, 0.9)]
    print(f"{retry_label}: {r_st.kv.retried_pages} of {r_st.kv.pages} page "
          f"reads retried, {r_st.kv.fast_pages} fast; first KV leaf {key}: "
          f"max|v| / rms p10 {q[0]:.4f} p50 {q[1]:.4f} p90 {q[2]:.4f}, so "
          f"half its pages retry below tau {q[1] / 254:.5f}", flush=True)
    return launches, held["flash_attention"], held["kv_retry"], out


# -- Mamba-2 serving and the RBER table: the SSD scan and RBER kernels ------


def _ssd_bound_ms(x, Bm, Cm, dt, dA, y, H, chunk):
    """Bytes (each input read once — B and C once per batch row — and
    each output written once) and the operations the data needs, over
    the HBM rate and the peak of the inputs' type, in milliseconds.  Per
    chunk of n real tokens, with n(n+1)/2 visible (query, key) pairs:
    the scores C.B^T once per batch row (2 ds flops a pair), and per
    head the decayed product with x*dt (2 hd a pair), C.H and the state
    update (2 n ds hd each)."""
    BH, T, hd = x.shape
    BG, _, ds = Bm.shape
    L = min(chunk, T)
    n_ops = 0.0
    for t0 in range(0, T, L):
        n = min(L, T - t0)
        pairs = n * (n + 1) / 2
        n_ops += BG * 2.0 * pairs * ds + BH * (2.0 * pairs * hd
                                               + 4.0 * n * ds * hd)
    peak = BF16_OPS_PER_S if x.dtype.itemsize == 2 else F32_OPS_PER_S
    n_bytes = sum(t.numel() * t.element_size()
                  for t in (x, Bm, Cm, dt, dA, y, H))
    return n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / peak * 1e3


def _ssd_ratios(y, H, want_y, want_H):
    """Worst |err| / tolerance of y (element by element in bfloat16: one
    bfloat16 ulp of the plain value plus 2^-8 of the row's rms; in
    float32, SSD_F32_TOL of the largest |y|) and of H (SSD_F32_TOL of
    the largest |H|)."""
    from repro_torch.kernels.flash_attention.plain import bf16_err_ratio

    if y.dtype.itemsize == 2:
        ry = bf16_err_ratio(y, want_y)
    else:
        ry = float((y - want_y).abs().max()) / (
            SSD_F32_TOL * max(float(want_y.abs().max()), 1e-30))
    rh = float((H - want_H).abs().max()) / (
        SSD_F32_TOL * max(float(want_H.abs().max()), 1e-30))
    return ry, rh


def _hold_ssd(name, args, chunk, got=None, reps=3, quiet=False):
    """Hold one SSD scan launch against the plain version on the same
    card tensors and time both."""
    import torch

    from repro_torch.kernels.ssd_scan import ops as SSD
    from repro_torch.kernels.ssd_scan.plain import ssd_scan_plain

    SSD.ssd_scan_fwd(*args, chunk=chunk)                  # warm-up
    ms, again = _cuda_ms(lambda: SSD.ssd_scan_fwd(*args, chunk=chunk), reps)
    y, H = again if got is None else got
    plain_ms, (want_y, want_H) = _cuda_ms(
        lambda: ssd_scan_plain(*args, chunk=chunk), 1)
    err = float((y.float() - want_y.float()).abs().max())
    ry, rh = _ssd_ratios(y, H, want_y, want_H)
    if not (ry <= 1.0 and rh <= 1.0) or not (
            torch.equal(y, again[0]) and torch.equal(H, again[1])):
        raise AssertionError(f"{name}: ssd_scan differs from its plain "
                             f"version (max abs {err}, worst |err| / "
                             f"tolerance y {ry}, H {rh}) or is not "
                             f"deterministic")
    t_bytes, t_ops = _ssd_bound_ms(*args, y, H, chunk)
    bound_ms, bound_by = _bound(t_bytes, t_ops)
    if not quiet:
        x, Bm = args[0], args[1]
        path = ("tensor-core" if SSD.uses_tensor_cores(
            x.dtype, x.shape[2], Bm.shape[2], x.shape[1], chunk) else "SIMT")
        print(f"{name}: x {tuple(x.shape)} B/C {tuple(Bm.shape)} {x.dtype} "
              f"chunk {chunk}, {path} path: max_abs_err {err:.3g} (worst |err| / "
              f"tolerance y {ry:.3g}, H {rh:.3g}) kernel {ms:.3f} ms plain "
              f"{plain_ms:.3f} ms bound {bound_ms:.4f} ms ({bound_by}; "
              f"bytes {t_bytes:.4f}, operations {t_ops:.4f})", flush=True)
    return dict(case=name, ms=ms, plain_ms=plain_ms, t_bytes=t_bytes,
                t_ops=t_ops, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=err, tol_ratio=ry, h_ratio=rh)


def _ssd_inputs(gen, B, nh, T, hd, ds, dtype):
    """Kernel-layout inputs of mamba2's scan, drawn on the card: x, B, C
    from N(0, 1) (B and C at 0.5) in ``dtype``; dt = softplus(N(0, 1) +
    dt_bias) with the model's dt_bias init (softplus(dt_bias) log-uniform
    over [1e-3, 1e-1]); A = -(1, ..., nh), the model's a_log init."""
    import math

    import torch
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    u = torch.rand(nh, generator=gen, device=DEVICE)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt = F.softplus(randn(B * nh, T) + bias.repeat(B)[:, None])
    A = -torch.arange(1, nh + 1, dtype=torch.float32, device=DEVICE)
    return (randn(B * nh, T, hd).to(dtype), (0.5 * randn(B, T, ds)).to(dtype),
            (0.5 * randn(B, T, ds)).to(dtype), dt, dt * A.repeat(B)[:, None])


def _check_ssd_controls(args, chunk):
    """The bfloat16 rule must reject both faulty variants of the plain
    version on the long prefill case; returns their worst ratios."""
    from repro_torch.kernels.flash_attention.plain import bf16_err_ratio
    from repro_torch.kernels.ssd_scan.plain import (faulty_ssd_plain,
                                                    ssd_scan_plain)

    want = ssd_scan_plain(*args, chunk=chunk)[0]
    out = {}
    for fault in ("w-bf16", "no-decay"):
        out[fault] = bf16_err_ratio(
            faulty_ssd_plain(*args, chunk, fault)[0], want)
        print(f"control {fault}: worst |err| / tolerance {out[fault]:.3g} "
              f"(must exceed 1)", flush=True)
        if not out[fault] > 1.0:
            raise AssertionError(f"the bfloat16 rule accepts the {fault} "
                                 f"control ({out[fault]})")
    return out


def _population():
    """Level means and sigmas of every page of the 160-chip population at
    CONDITION (the characterization's draws for its first page type,
    without the per-page jitter), (20 480, 8) each on the card, and the
    read levels of the 41-entry retry table, (41, 7)."""
    import torch

    from repro_torch.core import constants as C
    from repro_torch.core import prng
    from repro_torch.core import voltage as V

    key = prng.fold_in(prng.PRNGKey(0, device=DEVICE), 0)
    k_var, _ = prng.split(key)
    rate = V.sample_process_variation(k_var, C.N_CHIPS, N_BLOCKS)
    mu, sigma = V.degraded_distributions(*CONDITION, rate)
    mu, sigma = (t[:, :, None].expand(-1, -1, N_PAGES, -1).reshape(-1, 8)
                 .contiguous() for t in (mu, sigma))
    levels = V.retry_read_levels(torch.arange(
        C.MAX_RETRY_STEPS + 1, dtype=torch.float32, device=DEVICE))
    return mu, sigma, levels


def _sass_ops(ins):
    """Float32 operations of a kernel's straight path (the instructions
    before its first unpredicated EXIT), from its SASS: an FFMA counts
    two (the peak counts a fused multiply-add as two), every other float
    instruction (FADD, FMUL, FSETP, FSEL, FRND, FCHK, FMNMX) and MUFU one;
    integer, memory, move and control instructions none."""
    n = 0
    for i in ins:
        words = i.split()
        if words[0] == "EXIT":
            break
        op = words[1] if words[0].startswith("@") else words[0]
        if op.startswith("FFMA"):
            n += 2
        elif op.startswith(("FADD", "FMUL", "FSETP", "FSEL", "FRND", "FCHK",
                            "FMNMX", "MUFU")):
            n += 1
    return n


def _rber_op_counts():
    """Operations of one erfcf and of one IEEE float32 division, read
    from the SASS of the RBER library's probes (``cuobjdump -sass``):
    each probe's straight path against ``rber_probe_base``, which has
    the same loads, an add and the store (the division replaces that
    add)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.rber import ops as RB

    sass = build.sass(RB._SOURCE)
    base = _sass_ops(sass["rber_probe_base"])
    erfc = _sass_ops(sass["rber_probe_erfc"]) - base
    div = _sass_ops(sass["rber_probe_div"]) - base + 1
    for name in ("rber_probe_erfc", "rber_probe_div"):
        ops = [i.split()[1] if i.startswith("@") else i.split()[0]
               for i in sass[name]]
        print(f"SASS of {name}: {len(ops)} instructions: "
              f"{' '.join(ops)}", flush=True)
    print(f"RBER operations from the SASS: erfcf {erfc}, IEEE division "
          f"{div} (float instructions of the straight path, FFMA counted "
          f"twice; base probe {base})", flush=True)
    return erfc, div


def _rber_bound_ms(mu, levels, out, erfc_ops, div_ops):
    """Bytes (mu, sigma and the levels read once, the table written
    once) and the float32 operations of each (page, entry): per boundary
    2 subtractions, 2 divisions (``div_ops`` each), 2 scalings by
    1/sqrt(2), 2 erfcf (``erfc_ops`` each), 2 halvings, an add and the
    1/8, and its add into its page type's sum; in milliseconds."""
    N, S = mu.shape[0], levels.shape[0]
    n_bytes = 4 * (2 * mu.numel() + levels.numel() + out.numel())
    n_ops = N * S * 7 * (9 + 2 * div_ops + 2 * erfc_ops)
    return n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3


def _queued_ms(launch, reps):
    """Milliseconds a launch of ``launch()`` takes on the card alone:
    ``reps`` launches queued behind a sleeping stream, so the host's
    time between them is hidden, timed by CUDA events around them."""
    import torch

    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rber_main_path():
    """``rber_table`` on the card over the population's (mu, sigma) and the
    41-entry table, its count set to 0 just before and read just after;
    the launch is then held against the plain version and against the
    characterization's ``retry.rber_per_retry_step`` (no jitter, full
    tR), row by page type, and timed beside its bound."""
    import torch

    from repro_torch.core import constants as C
    from repro_torch.core import retry as R
    from repro_torch.kernels.rber import ops as RB
    from repro_torch.kernels.rber.plain import rber_plain

    mu, sigma, levels = _population()
    torch.cuda.synchronize()
    RB.launches = 0
    table = RB.rber_table(mu, sigma, levels)
    torch.cuda.synchronize()
    launches = RB.launches
    if launches != 1:
        raise AssertionError(f"rber_table launched the kernel {launches} "
                             f"times")
    RB.rber_fwd(mu, sigma, levels)                        # warm-up
    wrapper_ms, again = _cuda_ms(lambda: RB.rber_fwd(mu, sigma, levels),
                                 RBER_BARE_REPS)
    out = torch.empty_like(table)
    args = (mu.data_ptr(), sigma.data_ptr(), levels.data_ptr(),
            out.data_ptr(), mu.shape[0], levels.shape[0],
            torch.cuda.current_stream().cuda_stream)
    fn = RB._kernel_fn()

    def bare():
        if fn(*args) != 0:
            raise RuntimeError("rber kernel launch failed")

    ms = _queued_ms(bare, RBER_BARE_REPS)
    if not torch.equal(out, table):
        raise AssertionError("rber's bare launches differ from the wrapper's")
    plain_ms, want = _cuda_ms(lambda: rber_plain(mu, sigma, levels), 1)
    err = float((table - want).abs().max())
    if not (torch.allclose(table, want, rtol=RBER_RTOL, atol=RBER_ATOL)
            and torch.equal(table, again)):
        raise AssertionError(f"rber differs from its plain version (max abs "
                             f"{err}) or is not deterministic")
    char_err = 0.0
    for p, pt in enumerate(C.PAGE_TYPES):
        want_c = R.rber_per_retry_step(mu, sigma, pt)
        char_err = max(char_err, float((table[p] - want_c).abs().max()))
        if not torch.allclose(table[p], want_c, rtol=RBER_CHAR_RTOL,
                              atol=RBER_ATOL):
            raise AssertionError(f"rber {pt} row differs from "
                                 f"rber_per_retry_step (max abs {char_err})")
    t_bytes, t_ops = _rber_bound_ms(mu, levels, table, *_rber_op_counts())
    bound_ms, bound_by = _bound(t_bytes, t_ops)
    print(f"rber_table: population {tuple(mu.shape)} x {levels.shape[0]} "
          f"entries at {CONDITION[0]:g} d / {CONDITION[1]:g} P/E, {launches} "
          f"launch; max_abs_err {err:.3g} against the plain version (rtol "
          f"{RBER_RTOL}), {char_err:.3g} against rber_per_retry_step (rtol "
          f"{RBER_CHAR_RTOL}); RBER range {float(table.min()):.3g} .. "
          f"{float(table.max()):.3g}; kernel bare {ms:.5f} ms "
          f"({RBER_BARE_REPS} launches queued), through the wrapper "
          f"{wrapper_ms:.5f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}; bare kernel at "
          f"{bound_ms / ms * 100:.1f}% of it)", flush=True)
    return launches, dict(case="rber_table", ms=ms, wrapper_ms=wrapper_ms,
                          plain_ms=plain_ms, t_bytes=t_bytes, t_ops=t_ops,
                          bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=err)


def _ssd_stage_times(args, chunk):
    """Each kernel of the tensor-core path alone on the long case (the
    chunk states, the state passing, the scores, the chunk scan), after
    one run of all four has written their scratch; CUDA events over
    KERNEL_REPS launches."""
    from repro_torch.kernels.ssd_scan import ops as SSD

    runs, _ = SSD.tc_stage_launchers(*args, chunk=chunk)
    for r in runs:
        r()
    names = ("chunk states", "state passing", "scores", "chunk scan")
    out = {n: _cuda_ms(r, KERNEL_REPS)[0] for n, r in zip(names, runs)}
    print("ssd_scan tensor-core kernels on the long case: " + ", ".join(
        f"{n} {t:.4f} ms" for n, t in out.items()), flush=True)
    return out


@phase("ssd/rber kernels")
def ssd_rber_kernel_phase():
    import torch

    from repro_torch.kernels.ssd_scan import ops as SSD

    _hgmma_counts(SSD._SOURCE, "_tc_kernel", len(SSD.TC_STATE_DIMS))
    B, T, nh, hd, ds, chunk = SSD_SHAPE
    gen = torch.Generator(DEVICE).manual_seed(0)
    cases = [(f"mamba2 long prefill (B {B}, T {T}, {nh} heads), bf16", T,
              torch.bfloat16),
             (f"padded T {SSD_PADDED_T}, bf16", SSD_PADDED_T,
              torch.bfloat16),
             (f"mamba2 long prefill, float32", T, torch.float32)]
    ssd, controls = [], None
    for name, t, dtype in cases:
        args = _ssd_inputs(gen, B, nh, t, hd, ds, dtype)
        ssd.append(_hold_ssd(name, args, chunk))
        if controls is None:
            controls = _check_ssd_controls(args, chunk)
            _ssd_stage_times(args, chunk)
        del args
    torch.cuda.empty_cache()
    rber_launches, rber = _rber_main_path()
    return ssd, controls, rber_launches, rber


@phase("mamba serve path")
def mamba_serve_phase():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.retry import RetryPolicy
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.serving import ServeEngine

    _small_width_check(SSM_ARCH, 1.0)

    cfg = get_config(SSM_ARCH)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, policy=RetryPolicy("pr2ar2"), tau=SERVE_TAU,
                      seed=0, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(eng.params))
    print(f"{SSM_ARCH}: {n_params} seeded float32 parameters on the card "
          f"in {time.perf_counter() - t0:.3f} s", flush=True)
    engines = {"pr2ar2": eng,
               "baseline": ServeEngine(cfg, params=eng.params,
                                       policy=RetryPolicy("baseline"),
                                       tau=SERVE_TAU, device=DEVICE)}
    finite = _finite_checked(engines)
    sets = _request_sets(cfg.vocab)
    for e in engines.values():            # warm-up
        e.generate(sets[0][1], max_new_tokens=2)
    runs = [(f"mamba {s} {m}", e, p) for s, p in sets
            for m, e in engines.items()]
    launches, held, out = _drive(runs, ("ssd_scan",), finite)
    for label, (_, st, counts) in out.items():
        if counts["ssd_scan"] != cfg.n_layers:
            raise AssertionError(f"{label}: ssd_scan launched "
                                 f"{counts['ssd_scan']} times in one "
                                 f"prefill of {cfg.n_layers} SSD layers")
        if counts["flash_attention"] or counts["kv_retry"] or st.kv.pages:
            raise AssertionError(f"{label}: an attention-free model read "
                                 f"KV pages or attention: {counts}, {st.kv}")
    for set_name, _ in sets:
        p_gen, b_gen = (out[f"mamba {set_name} {m}"][0]
                        for m in ("pr2ar2", "baseline"))
        if not (p_gen == b_gen).all():
            raise AssertionError(f"mamba {set_name}: pr2ar2 and baseline "
                                 f"tokens differ through a passthrough "
                                 f"store")
    print(f"mamba: pr2ar2 == baseline tokens on both sets; {cfg.n_layers} "
          f"ssd_scan launches per prefill, all on the tensor-core path "
          f"({launches['ssd_scan_tc']} of {launches['ssd_scan']}), 0 KV "
          f"pages", flush=True)
    return launches["ssd_scan"], held["ssd_scan"]


# -- the sweep runtime: run_sweep / run_cells over the paper grid ----------


def _launches_of(stats):
    """Shard-core launches behind these cells, read off the cells: a
    fused cell shares one launch with ``fused_cells - 1`` others, an
    unfused batched cell has its own.  This counts launches made in
    spawned workers, which the parent's counter cannot see."""
    from fractions import Fraction

    n = sum(Fraction(1, s.fused_cells) if s.fused_cells else Fraction(1)
            for s in stats)
    if n.denominator != 1:
        raise AssertionError(f"fused_cells do not form whole launches: {n}")
    return int(n)


def _check_sweep_cells(label, res, kernel=True):
    import math

    for key, s in res.items():
        if s.n_requests != N_REQUESTS or not all(
                math.isfinite(v) for v in (s.mean_us, s.p99_us)):
            raise AssertionError(f"{label} {key}: bad stats {s}")
        if kernel and (s.engine_selected != "batched"
                       or s.fast_path_events <= 0 or s.fused_cells <= 0):
            raise AssertionError(f"{label} {key}: did not run fused on the "
                                 f"shard-core kernel: {s}")


def _timed_pools(RT, marks):
    """Patch the runtime's pool class to record when each pool is made
    and when its first task comes back; returns the restore callable."""
    base = RT.ProcessPoolExecutor

    class TimedPool(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            marks.append({"created": time.perf_counter(), "first": None})

        def submit(self, *a, **kw):
            fut = super().submit(*a, **kw)
            mark = marks[-1]

            def done(_):
                if mark["first"] is None:
                    mark["first"] = time.perf_counter()
            fut.add_done_callback(done)
            return fut

    RT.ProcessPoolExecutor = TimedPool

    def restore():
        RT.ProcessPoolExecutor = base
    return restore


@phase("sweep runtime")
def sweep_phase(smi):
    import json as _json

    import torch

    from repro_torch.flashsim import (OperatingCondition, compare_mechanisms,
                                      runtime as RT)
    from repro_torch.kernels.fcfs_core import ops as K

    conds = tuple(OperatingCondition(*c) for c in SWEEP_CONDITIONS)
    kw = dict(n_requests=N_REQUESTS, engine="batched", device=DEVICE)
    grid = f"{len(conds)} x {len(MECHANISMS)} x {len(SWEEP_SEEDS)}"
    t0 = time.perf_counter()
    n_tables = RT.prewarm_characterization(
        [RT.Cell("batch", WORKLOAD, conds, MECHANISMS, s, **kw)
         for s in SWEEP_SEEDS])
    torch.cuda.synchronize()
    print(f"sweep: {n_tables} (condition, mechanism) tables characterized "
          f"on the card in {time.perf_counter() - t0:.3f} s", flush=True)

    # Keep the inline sweep's first launch, to hold it against the plain
    # version once the counts are read.
    recorded = []
    fwd = K.fcfs_core_fwd

    def recording_fwd(ops, timing, steps, **kwargs):
        out = fwd(ops, timing, steps, **kwargs)
        if not recorded:
            recorded.append((ops, timing, steps, kwargs, out))
        return out

    walls, blobs, launches, startup, results = {}, {}, {}, {}, {}
    marks = []
    restore = _timed_pools(RT, marks)
    try:
        for w in SWEEP_WORKERS:
            n_pools = len(marks)
            if w == 1:
                K.fcfs_core_fwd = recording_fwd
                secs, restore_timers = _host_timers()
                K.launches = 0
            t0 = time.perf_counter()
            res = RT.run_sweep(WORKLOAD, conds, MECHANISMS, SWEEP_SEEDS,
                               workers=w, **kw)
            torch.cuda.synchronize()
            walls[w] = time.perf_counter() - t0
            if w == 1:
                counted = K.launches
                restore_timers()
                K.fcfs_core_fwd = fwd
                top = sum(v for k, v in secs.items()
                          if "(in dispatch)" not in k)
                print(f"host phases of the inline sweep ({walls[w]:.4f} s "
                      f"on the host clock): " + ", ".join(
                          f"{k} {v:.4f} s" for k, v in secs.items())
                      + f", rest {walls[w] - top:.4f} s", flush=True)
            _check_sweep_cells(f"workers={w}", res)
            results[w], blobs[w] = res, RT.sweep_to_json(res)
            launches[w] = _launches_of(res.values())
            if w > 1:
                if len(marks) != n_pools + 1:
                    raise AssertionError(f"workers={w}: {len(marks) - n_pools}"
                                         f" pools made, expected 1")
                startup[w] = marks[-1]["first"] - marks[-1]["created"]
            sizes = sorted({s.fused_cells for s in res.values()})
            print(f"sweep {grid} at workers={w}: {walls[w]:.3f} s "
                  f"({walls[w] / len(SWEEP_SEEDS):.4f} s a seed group), "
                  f"{launches[w]} shard-core launches read from fused_cells "
                  f"(cells a launch: {sizes})"
                  + (f", spawn start-up {startup[w]:.3f} s" if w > 1 else
                     f", {counted} counted in the process"), flush=True)
    finally:
        K.fcfs_core_fwd = fwd
        restore()
    if counted <= 0 or counted != launches[1]:
        raise AssertionError(f"inline sweep: {counted} kernel launches "
                             f"counted, {launches[1]} read from fused_cells")
    for w in SWEEP_WORKERS[1:]:
        if blobs[w] != blobs[1]:
            raise AssertionError(f"sweep_to_json at workers={w} differs "
                                 f"from workers=1")
        if launches[w] != launches[1]:
            raise AssertionError(f"workers={w}: {launches[w]} launches, "
                                 f"inline {launches[1]}")
    print(f"sweep: sweep_to_json byte-identical at workers "
          f"{SWEEP_WORKERS} ({len(blobs[1])} bytes)", flush=True)
    inline = results[1]

    t0 = time.perf_counter()
    sub = RT.run_sweep(WORKLOAD, conds, SWEEP_ARRAY_MECHANISMS,
                       SWEEP_SEEDS[:1], n_requests=N_REQUESTS,
                       engine="array", device=DEVICE)
    array_s = time.perf_counter() - t0
    _check_sweep_cells("array sub-grid", sub, kernel=False)
    want = {k: inline[k] for k in sub}
    if RT.sweep_to_json(sub) != RT.sweep_to_json(want):
        raise AssertionError("array sub-grid differs from the batched sweep")
    print(f"sweep: array engine on {len(sub)} cells (seed "
          f"{SWEEP_SEEDS[0]}, {SWEEP_ARRAY_MECHANISMS}) in {array_s:.3f} s, "
          f"sweep_to_json equal to the batched sweep's", flush=True)

    jpath = CACHE / "sweep_journal.jsonl"
    jpath.parent.mkdir(parents=True, exist_ok=True)
    jpath.unlink(missing_ok=True)
    t0 = time.perf_counter()
    jres = RT.run_sweep(WORKLOAD, conds, MECHANISMS, SWEEP_SEEDS,
                        workers=SWEEP_WORKERS[-1], journal=jpath, **kw)
    journal_s = time.perf_counter() - t0
    lines = jpath.read_text().splitlines()
    if RT.sweep_to_json(jres) != blobs[1] or \
            len(lines) != 1 + len(SWEEP_SEEDS):
        raise AssertionError(f"journaled sweep: {len(lines)} journal lines "
                             f"or its bytes differ")
    kept = SWEEP_SEEDS[_json.loads(lines[1])["i"]]
    jpath.write_text("\n".join(lines[:2]) + "\n")
    K.launches = 0
    t0 = time.perf_counter()
    resumed = RT.run_sweep(WORKLOAD, conds, MECHANISMS, SWEEP_SEEDS,
                           journal=jpath, **kw)
    resume_s = time.perf_counter() - t0
    resumed_launches = K.launches
    want_launches = launches[1] - _launches_of(
        v for k, v in inline.items() if k[2] == kept)
    if RT.sweep_to_json(resumed) != blobs[1]:
        raise AssertionError("resumed sweep differs from the full sweep")
    if resumed_launches != want_launches:
        raise AssertionError(f"resumed sweep launched {resumed_launches} "
                             f"times, the missing seed groups need "
                             f"{want_launches}")
    print(f"sweep: journaled at workers={SWEEP_WORKERS[-1]} in "
          f"{journal_s:.3f} s; cut to its header and seed {kept}'s group, "
          f"resumed inline in {resume_s:.3f} s with {resumed_launches} "
          f"launches (the {len(SWEEP_SEEDS) - 1} missing groups), "
          f"byte-identical", flush=True)

    fcells = [RT.Cell("simulate", WORKLOAD, conds[:1], (m,), s, **kw)
              for s in FUSION_SEEDS for m in MECHANISMS]
    K.launches = 0
    fres = RT.run_cells(fcells, workers=1)
    fused_launches = K.launches
    chunks = _launches_of(fres)
    if max(s.fused_cells for s in fres) <= 1 or fused_launches != chunks:
        raise AssertionError(f"cross-cell fusion: fused_cells "
                             f"{[s.fused_cells for s in fres]}, "
                             f"{fused_launches} launches for {chunks} chunks")
    for c, st in zip(fcells, fres):
        key = (c.mechanisms[0], conds[0], c.seed)
        if RT._stats_payload(st) != RT._stats_payload(inline[key]):
            raise AssertionError(f"cross-cell fused {key} differs from the "
                                 f"sweep's cell")
    print(f"sweep: {len(fcells)} simulate cells of seeds {FUSION_SEEDS} "
          f"fused across cells into {fused_launches} launches (cells a "
          f"launch: {[s.fused_cells for s in fres]}), equal to the sweep's "
          f"cells", flush=True)

    walls_cmp = {}
    cmp = {}
    for w in (1, 2):
        t0 = time.perf_counter()
        cmp[w] = compare_mechanisms(WORKLOAD, conds[0],
                                    SWEEP_ARRAY_MECHANISMS,
                                    n_requests=N_REQUESTS, engine="array",
                                    workers=w, device=DEVICE)
        walls_cmp[w] = time.perf_counter() - t0
    if {m: RT._stats_payload(s) for m, s in cmp[1].items()} != \
            {m: RT._stats_payload(s) for m, s in cmp[2].items()}:
        raise AssertionError("compare_mechanisms(engine='array') differs "
                             "between workers 1 and 2")
    print(f"sweep: compare_mechanisms(engine='array') at workers 1 "
          f"{walls_cmp[1]:.3f} s and 2 (forked) {walls_cmp[2]:.3f} s, equal",
          flush=True)

    ops, timing, steps, kwargs, out = recorded[0]
    held = _hold(f"sweep launch 0 ({ops.shape[0]} lanes)", ops, timing,
                 steps, kwargs, got=out)
    kernel_s = held["ms"] * 1e-3 * counted
    print(f"sweep: the inline sweep's {counted} launches at the held "
          f"launch's {held['ms']:.3f} ms are {kernel_s:.3f} s, "
          f"{kernel_s / walls[1]:.1%} of its wall", flush=True)
    print(smi)
    summary = dict(grid=grid, n_requests=N_REQUESTS, walls_s=walls,
                   per_group_s={w: v / len(SWEEP_SEEDS)
                                for w, v in walls.items()},
                   spawn_startup_s=startup, launches=launches,
                   counted_inline=counted, array_subgrid_s=array_s,
                   journal_s=journal_s, resume_s=resume_s,
                   resumed_launches=resumed_launches,
                   fusion_launches=fused_launches,
                   compare_array_s=walls_cmp)
    print("sweep summary: " + _json.dumps(summary), flush=True)
    return counted, held


# -- prepass GC: the FTL pre-pass feeding erases and GC traffic to B1 ------


def _ftl_stats(s):
    return (s.wa, s.gc_invocations, s.gc_page_reads, s.gc_page_progs,
            s.blocks_erased)


def _check_gc_cells(label, res):
    import math

    for key, s in res.items():
        if s.n_requests != N_REQUESTS or not all(
                math.isfinite(v) for v in (s.mean_us, s.read_p99_us)):
            raise AssertionError(f"{label} {key}: bad stats {s}")
        if not (s.wa > 1.0 and s.gc_invocations == s.blocks_erased > 0):
            raise AssertionError(f"{label} {key}: no GC in a prepass run: "
                                 f"{s}")


@phase("prepass GC")
def gc_phase(smi, chain_ns):
    import json as _json

    import numpy as np
    import torch

    from repro_torch.core import characterize as TC
    from repro_torch.flashsim import (GCConfig, OperatingCondition,
                                      SSDConfig, build_ftl_schedule,
                                      compare_mechanisms, runtime as RT)
    from repro_torch.flashsim.ftl import OP_GC_READ
    from repro_torch.flashsim.ssd import resolve_trace
    from repro_torch.kernels.fcfs_core import ops as K

    cond = OperatingCondition(*CONDITION)
    kw = dict(n_requests=N_REQUESTS, gc="prepass", device=DEVICE)
    # Keep every launch of the compare, to hold the first against the
    # plain version once the counts are read.
    recorded = []
    fwd = K.fcfs_core_fwd

    def recording_fwd(ops, timing, steps, **kwargs):
        out = fwd(ops, timing, steps, **kwargs)
        recorded.append((ops, timing, steps, kwargs, out))
        return out

    K.fcfs_core_fwd = recording_fwd
    secs, restore = _host_timers()
    K.launches = K.smem_launches = 0
    try:
        t0 = time.perf_counter()
        res = compare_mechanisms(GC_WORKLOAD, cond, MECHANISMS,
                                 engine="batched", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, smem_launches = K.launches, K.smem_launches
    finally:
        restore()
        K.fcfs_core_fwd = fwd
    chunks = _launches_of(res.values())
    if launches <= 0 or launches != chunks or len(recorded) != launches:
        raise AssertionError(f"prepass GC compare: {launches} launches "
                             f"counted, {chunks} chunks read from "
                             f"fused_cells, {len(recorded)} recorded")
    _check_gc_cells("prepass GC batched", res)
    ops0, timing0, steps0, kw0, out0 = recorded[0]
    kinds, hp = ops0[:, :, 1], ops0[:, :, 6]
    n_erase = int((kinds == 2.0).sum())
    n_gc_reads = int(((kinds == 0.0) & (hp == 0.0)).sum())
    if n_erase <= 0 or n_gc_reads <= 0:
        raise AssertionError(f"prepass GC launch 0 holds {n_erase} erases "
                             f"and {n_gc_reads} low-priority reads")
    resident = K.resident_lanes(ops0.shape[1], kw0["n_dies"], kw0["capq"],
                                kw0["capw"], kw0["prio"], DEVICE)
    variant, smem = _variant(ops0, kw0)
    print(f"prepass GC: {launches} shard-core launches ({smem_launches} "
          f"from shared memory, launch 0 variant {variant}) for "
          f"{len(MECHANISMS)} mechanisms x 8 lanes; the card holds "
          f"{resident} lanes at once at launch 0's footprint (maxp "
          f"{ops0.shape[1]}, capq {kw0['capq']}, capw {kw0['capw']}); "
          f"launch 0 holds {int((kinds != 3.0).sum())} op rows, {n_erase} "
          f"erases and {n_gc_reads} low-priority reads", flush=True)
    top = sum(v for k, v in secs.items() if "(in dispatch)" not in k)
    print(f"host phases of the prepass GC compare ({wall:.4f} s on the "
          f"host clock, synchronized): " + ", ".join(
              f"{k} {v:.4f} s" for k, v in secs.items())
          + f", rest {wall - top:.4f} s", flush=True)

    t0 = time.perf_counter()
    ref = compare_mechanisms(GC_WORKLOAD, cond, MECHANISMS, engine="array",
                             **kw)
    array_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    unfused = compare_mechanisms(GC_WORKLOAD, cond, MECHANISMS,
                                 engine="batched", fuse=False, **kw)
    torch.cuda.synchronize()
    unfused_s = time.perf_counter() - t0
    for m in MECHANISMS:
        if _outcome(res[m]) != _outcome(ref[m]):
            raise AssertionError(f"prepass GC {m}: batched SimStats differ "
                                 f"from the array interpreter's")
        if _outcome(res[m]) != _outcome(unfused[m]):
            raise AssertionError(f"prepass GC {m}: fused SimStats differ "
                                 f"from the unfused run's")
        if res[m].fast_path_events <= 0:
            raise AssertionError(f"prepass GC {m}: no events went through "
                                 f"the kernel")
    ftl = {_ftl_stats(s) for s in res.values()}
    if len(ftl) != 1:
        raise AssertionError(f"prepass GC: FTL stats differ between "
                             f"mechanisms: {ftl}")
    wa, gc_inv, gc_reads, gc_progs, erased = ftl.pop()
    print(f"prepass GC: WA {wa}, {gc_inv} GC passes, {gc_reads} copy-back "
          f"reads and {gc_progs} programs, {erased} erases, equal for every "
          f"mechanism; batched {wall:.3f} s ({launches} launches), unfused "
          f"{unfused_s:.3f} s ({_launches_of(unfused.values())} launches), "
          f"array interpreter {array_s:.3f} s; batched == array and fused "
          f"== unfused for all six", flush=True)

    inplace = compare_mechanisms(GC_WORKLOAD, cond, MECHANISMS,
                                 n_requests=N_REQUESTS, engine="batched",
                                 device=DEVICE)
    for m in MECHANISMS:
        g, p = res[m], inplace[m]
        print(f"{m:>12}: prepass GC mean {g.mean_us:.3f} us read p99 "
              f"{g.read_p99_us:.3f} us attempts {g.mean_read_attempts:.3f} "
              f"| in place mean {p.mean_us:.3f} us read p99 "
              f"{p.read_p99_us:.3f} us attempts {p.mean_read_attempts:.3f}",
              flush=True)

    t0 = time.perf_counter()
    prio = compare_mechanisms(GC_WORKLOAD, cond, GC_PRIO_MECHANISMS,
                              engine="batched", scheduler=GC_PRIO_SCHEDULER,
                              **kw)
    torch.cuda.synchronize()
    prio_s = time.perf_counter() - t0
    prio_ref = compare_mechanisms(GC_WORKLOAD, cond, GC_PRIO_MECHANISMS,
                                  engine="array",
                                  scheduler=GC_PRIO_SCHEDULER, **kw)
    _check_gc_cells("prepass GC aged rings", prio)
    for m in GC_PRIO_MECHANISMS:
        if _outcome(prio[m]) != _outcome(prio_ref[m]):
            raise AssertionError(f"prepass GC {GC_PRIO_SCHEDULER} {m}: "
                                 f"batched differs from the array "
                                 f"interpreter")
        print(f"{m:>12} ({GC_PRIO_SCHEDULER}): mean {prio[m].mean_us:.3f} "
              f"us read p99 {prio[m].read_p99_us:.3f} us", flush=True)
    print(f"prepass GC: {GC_PRIO_SCHEDULER} batched ({prio_s:.3f} s) == "
          f"array for {GC_PRIO_MECHANISMS}", flush=True)

    wear_cfg = SSDConfig(gc=GCConfig(enabled=True,
                                     pec_per_erase=GC_PEC_PER_ERASE))
    conds = tuple(OperatingCondition(*c) for c in SWEEP_CONDITIONS)
    walls, blobs, sweep_launches = {}, {}, {}
    for w in (1, 2):
        t0 = time.perf_counter()
        out = RT.run_sweep(GC_WORKLOAD, conds, GC_PRIO_MECHANISMS,
                           GC_WEAR_SEEDS, cfg=wear_cfg,
                           n_requests=N_REQUESTS, engine="batched",
                           workers=w, device=DEVICE)
        torch.cuda.synchronize()
        walls[w] = time.perf_counter() - t0
        _check_sweep_cells(f"worn-bin sweep workers={w}", out)
        _check_gc_cells(f"worn-bin sweep workers={w}", out)
        blobs[w], sweep_launches[w] = RT.sweep_to_json(out), \
            _launches_of(out.values())
        if w == 1:
            worn = out
    if blobs[2] != blobs[1]:
        raise AssertionError("worn-bin sweep: sweep_to_json differs between "
                             "workers 1 and 2")
    # The sweep's own traffic: each seed's FTL schedule (host code with
    # no RNG, the one the sweep built) must read blocks that GC erased
    # before; count those reads by the P/E bin each condition samples
    # them from, and each such bin must have been characterized.
    done = ({(k[0], k[1]) for k in TC._COND_MEMO}
            | {(k[0], k[1]) for k in TC._HIST_MEMO})
    read_bins = {(c.retention_days, c.pec): {} for c in conds}
    for s in GC_WEAR_SEEDS:
        sched = build_ftl_schedule(
            resolve_trace(GC_WORKLOAD, seed=s, n_requests=N_REQUESTS),
            wear_cfg)
        is_worn = (sched.kind <= OP_GC_READ) & (sched.wear_pec > 0.0)
        if not is_worn.any():
            raise AssertionError(f"worn-bin sweep seed {s}: no read of a "
                                 f"block GC erased before")
        wear, n = np.unique(sched.wear_pec[is_worn], return_counts=True)
        for c in conds:
            counts = read_bins[(c.retention_days, c.pec)]
            for w, k in zip(wear.tolist(), n.tolist()):
                b = TC.snap_pec(c.with_wear(w).pec)
                counts[b] = counts.get(b, 0) + k
    for (ret, pec), counts in read_bins.items():
        missing = [b for b in counts if b != pec and (ret, b) not in done]
        if not counts or missing:
            raise AssertionError(f"worn-bin sweep at {ret:g} d / {pec:g} "
                                 f"P/E: worn reads by bin {counts}, bins "
                                 f"not characterized {missing}")
    att = {(m, c.retention_days): worn[(m, c, GC_WEAR_SEEDS[0])]
           .mean_read_attempts for c in conds for m in GC_PRIO_MECHANISMS}
    print(f"prepass GC worn-bin sweep ({len(conds)} x "
          f"{len(GC_PRIO_MECHANISMS)} x {len(GC_WEAR_SEEDS)} at "
          f"{GC_PEC_PER_ERASE:g} P/E an erase): workers 1 {walls[1]:.3f} s, "
          f"workers 2 (spawned) {walls[2]:.3f} s, {sweep_launches[1]} and "
          f"{sweep_launches[2]} launches read from fused_cells, "
          f"sweep_to_json byte-identical ({len(blobs[1])} bytes); reads "
          f"of GC-erased blocks by (days, P/E) and the P/E bin they are "
          f"sampled from, over seeds {GC_WEAR_SEEDS}: {read_bins}; seed "
          f"{GC_WEAR_SEEDS[0]}'s "
          f"read attempts by (mechanism, retention days): {att}",
          flush=True)

    held = _hold(f"prepass-GC launch 0 ({ops0.shape[0]} lanes, "
                 f"{int((timing0[:, 3] != 0).sum())} pipelined)", ops0,
                 timing0, steps0, kw0, got=out0, plain_steps=GC_HOLD_STEPS)
    held["chain_ms"] = held["longest"] * chain_ns * 1e-6
    print(f"  chain bound {held['chain_ms']:.3f} ms = {held['longest']} "
          f"steps x {chain_ns:.3f} ns; kernel at "
          f"{held['ms'] / held['chain_ms']:.1f}x its chain bound", flush=True)
    print(smi)
    summary = dict(workload=GC_WORKLOAD, n_requests=N_REQUESTS,
                   wall_s=wall, host_s=secs, launches=launches,
                   smem_launches=smem_launches, resident_lanes=resident,
                   variant=variant, maxp=int(ops0.shape[1]),
                   longest_lane_steps=held["longest"],
                   launch_ms=held["ms"], plain_ms=held["plain_ms"],
                   bound_ms=held["bound_ms"], array_s=array_s,
                   unfused_s=unfused_s, wa=wa, gc_invocations=gc_inv,
                   worn_sweep_s=walls, worn_sweep_launches=sweep_launches)
    print("prepass GC summary: " + _json.dumps(summary), flush=True)
    return launches, smem_launches, held, res, inplace


def _golden_closed_cells():
    """The pinned open-loop cells of ``golden_closed_loop.json`` the port
    runs (gc off or prepass, no faults): ``(meta, {key: pinned})``."""
    g = json.loads(CLOSED_GOLDEN.read_text())
    cells = {k: v for k, v in g["cells"].items()
             if k.split("|")[2] != "online" and k.endswith("|none")}
    cond = g["meta"]["condition"]
    if len(cells) != 12 or (cond["retention_days"], cond["pec"]) != \
            CONDITION:
        raise AssertionError(f"{CLOSED_GOLDEN}: {len(cells)} reachable "
                             f"cells at {cond}")
    return g["meta"], cells


def _check_pinned(ctx, stats, want):
    import dataclasses
    import math

    got = dataclasses.asdict(stats)
    for field, v in want.items():
        if field in ("die_util", "channel_util"):
            ok = abs(got[field] - v) <= CLOSED_ULPS * math.ulp(v)
        else:
            ok = got[field] == v
        if not ok:
            raise AssertionError(f"{ctx}.{field}: {got[field]!r} against "
                                 f"the pin {v!r}")


def _check_closed(label, s, qd, n):
    import math

    from repro_torch.flashsim import DEFAULT_SSD

    if s.n_requests != n or not all(math.isfinite(v) for v in (
            s.mean_us, s.read_p99_us, s.throughput_iops)):
        raise AssertionError(f"{label}: bad stats {s}")
    if not 1 <= s.max_inflight <= qd:
        raise AssertionError(f"{label}: max_inflight {s.max_inflight} "
                             f"outside [1, {qd}]")
    split = (s.hostq_wait_mean_us + s.device_mean_us
             + DEFAULT_SSD.host_overhead_us)
    if abs(split - s.mean_us) > 1e-9 * abs(s.mean_us):
        raise AssertionError(f"{label}: mean {s.mean_us!r} != wait "
                             f"{s.hostq_wait_mean_us!r} + device "
                             f"{s.device_mean_us!r} + host overhead")
    if s.engine_selected != "array" or s.fast_path_events != 0:
        raise AssertionError(f"{label}: a closed cell left the array "
                             f"interpreter: {s}")


@phase("closed loop")
def closed_loop_phase(smi):
    import math

    import torch

    from repro_torch.core.retry import RetryPolicy
    from repro_torch.flashsim import (BatchedUnsupported, DEFAULT_SSD,
                                      GCConfig, HostCacheConfig,
                                      OperatingCondition, SSDConfig, SSDSim,
                                      build_ftl_schedule,
                                      compare_mechanisms, simulate)
    from repro_torch.flashsim.ssd import resolve_trace
    from repro_torch.kernels.fcfs_core import ops as K

    print(smi, flush=True)
    cond = OperatingCondition(*CONDITION)
    overhead = DEFAULT_SSD.host_overhead_us
    meta, cells = _golden_closed_cells()
    # The golden cells' batched and auto launches and the deep queue's
    # open-loop launch are this phase's main path: keep each launch to
    # hold once the counts are read.
    recorded = []
    fwd = K.fcfs_core_fwd

    def recording_fwd(ops, timing, steps, **kw):
        out = fwd(ops, timing, steps, **kw)
        recorded.append((ops, timing, steps, kw, out))
        return out

    K.fcfs_core_fwd = recording_fwd
    K.launches = K.smem_launches = 0
    try:
        t0 = time.perf_counter()
        golden = []
        for key in sorted(cells):
            mech, sched, gc, _ = key.split("|")
            wl = (meta["extra_workload"] if mech in ("baseline",
                                                     "sota+pr2ar2")
                  else meta["workload"])
            engines = (("array", "batched", "auto") if sched in CLOSED_RING
                       else ("array",))
            for engine in engines:
                n_rec = len(recorded)
                s = simulate(wl, cond, mech, seed=meta["seed"],
                             n_requests=meta["n_requests"], scheduler=sched,
                             gc=gc, engine=engine, device=DEVICE)
                golden.append((key, engine, s, recorded[n_rec:]))
        torch.cuda.synchronize()
        golden_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        open_ = compare_mechanisms(WORKLOAD, cond, CLOSED_MECHANISMS,
                                   n_requests=N_REQUESTS, engine="batched",
                                   device=DEVICE)
        torch.cuda.synchronize()
        open_s = time.perf_counter() - t0
        launches, smem_launches = K.launches, K.smem_launches
    finally:
        K.fcfs_core_fwd = fwd
    kernel_stats = [s for _, e, s, _ in golden if e != "array"]
    kernel_stats += list(open_.values())
    chunks = _launches_of(kernel_stats)
    if launches <= 0 or launches != chunks or len(recorded) != launches:
        raise AssertionError(f"closed loop: {launches} launches counted, "
                             f"{chunks} read from fused_cells, "
                             f"{len(recorded)} recorded")
    by_cell = {}
    for key, engine, s, recs in golden:
        _check_pinned(f"{key}[{engine}]", s, cells[key])
        want_engine = "array" if engine == "array" else "batched"
        if s.engine_selected != want_engine or \
                (s.fast_path_events > 0) != (engine != "array"):
            raise AssertionError(f"{key}[{engine}]: ran on "
                                 f"{s.engine_selected}")
        if len(recs) != (0 if engine == "array" else 1):
            raise AssertionError(f"{key}[{engine}]: {len(recs)} launches")
        by_cell.setdefault(key, {})[engine] = recs
    n_ring = sum(1 for k in cells if k.split("|")[1] in CLOSED_RING)
    print(f"closed loop: {len(cells)} pinned open-loop cells of "
          f"{CLOSED_GOLDEN.name} equal to their pins on the card's "
          f"characterization ({CLOSED_ULPS} ulps on die_util and "
          f"channel_util), {n_ring} of them also through engine='batched' "
          f"and 'auto': {golden_s:.3f} s; {launches} shard-core launches "
          f"({smem_launches} from shared memory) with the deep queue's "
          f"open-loop compare ({open_s:.3f} s)", flush=True)

    # Each batched golden launch against the plain version; the auto
    # launch of the same cell must give the same bits.
    held = []
    for key in sorted(by_cell):
        recs = by_cell[key]
        if "batched" not in recs:
            continue
        ops, timing, steps, kw, out = recs["batched"][0]
        a_ops, _, _, _, a_out = recs["auto"][0]
        if not (torch.equal(ops, a_ops) and all(
                torch.equal(x, y) for x, y in zip(out, a_out))):
            raise AssertionError(f"{key}: the auto launch differs from the "
                                 f"batched launch")
        held.append(_hold(f"golden {key}", ops, timing, steps, kw, got=out))

    # The QD ladder over one trace.  From here on every cell is closed:
    # host code, no shard-core launch.
    K.launches = 0
    ladder, walls = {m: [] for m in CLOSED_MECHANISMS}, {}
    for qd in CLOSED_LADDER:
        t0 = time.perf_counter()
        res = compare_mechanisms(WORKLOAD, cond, CLOSED_MECHANISMS,
                                 n_requests=N_REQUESTS, ncq_depth=qd,
                                 device=DEVICE)
        walls[qd] = time.perf_counter() - t0
        for m, s in res.items():
            _check_closed(f"QD {qd} {m}", s, qd, N_REQUESTS)
            ladder[m].append(s)
    for m, rungs in ladder.items():
        iops = [s.throughput_iops for s in rungs]
        for lo, hi in zip(iops, iops[1:]):
            if hi < lo * (1 - 1e-9):
                raise AssertionError(f"{m}: IOPS dropped up the ladder: "
                                     f"{iops}")
        if not (iops[1] / iops[0] > 1.7 and iops[-1] / iops[-2] < 1.5):
            raise AssertionError(f"{m}: no knee in the ladder: {iops}")
        for qd, s in zip(CLOSED_LADDER, rungs):
            print(f"{m:>12} QD {qd:>2}: {s.throughput_iops:.3f} IOPS, mean "
                  f"{s.mean_us:.3f} us = wait {s.hostq_wait_mean_us:.3f} + "
                  f"device {s.device_mean_us:.3f} + {overhead:g}, "
                  f"read p99 {s.read_p99_us:.3f} us, read device p99 "
                  f"{s.read_device_p99_us:.3f} us, max_inflight "
                  f"{s.max_inflight}, die sense util "
                  f"{s.die_sense_util:.4f}", flush=True)
    q8 = CLOSED_LADDER.index(8)
    base, pipe = ladder["baseline"][q8], ladder["sota+pr2ar2"][q8]
    if not (pipe.throughput_iops > base.throughput_iops * 1.2
            and pipe.read_p99_us < base.read_p99_us
            and pipe.die_sense_util > 0.0):
        raise AssertionError(f"QD 8: pipelining does not win: {pipe} "
                             f"against {base}")
    print(f"QD ladder ({WORKLOAD}, {N_REQUESTS} requests, two mechanisms "
          f"a rung, host wall by QD on {smi}): " + ", ".join(
              f"QD {qd} {w:.3f} s" for qd, w in walls.items()), flush=True)

    # The deep queue admits every request at its arrival: the open loop.
    t0 = time.perf_counter()
    deep = compare_mechanisms(WORKLOAD, cond, CLOSED_MECHANISMS,
                              n_requests=N_REQUESTS, ncq_depth=N_REQUESTS,
                              device=DEVICE)
    deep_s = time.perf_counter() - t0
    for m in CLOSED_MECHANISMS:
        d, o = deep[m], open_[m]
        _check_closed(f"deep queue {m}", d, N_REQUESTS, N_REQUESTS)
        if o.engine_selected != "batched" or o.fast_path_events <= 0:
            raise AssertionError(f"open loop {m}: not on the kernel")
        if not (math.isclose(d.mean_us, o.mean_us, rel_tol=1e-12)
                and math.isclose(d.read_p99_us, o.read_p99_us,
                                 rel_tol=1e-12)
                and d.hostq_wait_mean_us == 0.0):
            raise AssertionError(f"deep queue {m}: {d} against the open "
                                 f"loop {o}")
        print(f"{m:>12} deep queue: mean {d.mean_us!r} us, read p99 "
              f"{d.read_p99_us!r} us, wait {d.hostq_wait_mean_us!r} | open "
              f"loop on the kernel: mean {o.mean_us!r} us, read p99 "
              f"{o.read_p99_us!r} us", flush=True)
    try:
        simulate(WORKLOAD, cond, "pr2ar2", n_requests=200, ncq_depth=8,
                 engine="batched", device=DEVICE)
        raise AssertionError("engine='batched' ran a closed-loop cell")
    except BatchedUnsupported as e:
        refusal = str(e)
    auto = simulate(WORKLOAD, cond, "pr2ar2", n_requests=200, ncq_depth=8,
                    engine="auto", device=DEVICE)
    if auto.engine_selected != "array" or \
            auto.engine_fallback_reason != refusal:
        raise AssertionError(f"auto on a closed cell: {auto}")
    print(f"deep queue (QD {N_REQUESTS}) {deep_s:.3f} s == open loop on "
          f"the kernel; engine='batched' refuses the closed loop and auto "
          f"records: {refusal!r}", flush=True)

    # The GC cell closed: one FTL schedule, two mechanisms, with and
    # without the host write-back cache.
    trace = resolve_trace(GC_WORKLOAD, seed=0, n_requests=N_REQUESTS)
    gc_on = GCConfig(enabled=True)
    t0 = time.perf_counter()
    schedule = build_ftl_schedule(trace, SSDConfig(gc=gc_on))
    ftl_s = time.perf_counter() - t0
    gc_cells = {}
    for cache in (None, HostCacheConfig()):
        cfg = SSDConfig(gc=gc_on, ncq_depth=CLOSED_GC_QD,
                        host_cache=cache)
        label = "no cache" if cache is None else "host cache"
        for m in CLOSED_GC_MECHANISMS:
            t0 = time.perf_counter()
            s = SSDSim(cfg, cond, RetryPolicy(m), seed=7,
                       device=DEVICE).run(trace, schedule=schedule)
            wall = time.perf_counter() - t0
            _check_closed(f"GC {m} {label}", s, CLOSED_GC_QD, N_REQUESTS)
            if not (s.wa > 1.0 and s.gc_invocations > 0):
                raise AssertionError(f"GC {m} {label}: no GC: {s}")
            if cache is not None and not (
                    s.cache_absorbed_writes > 0
                    and s.cache_flush_pages >= s.cache_absorbed_writes):
                raise AssertionError(f"GC {m} {label}: cache counters {s}")
            gc_cells[(m, label)] = (s, wall)
            print(f"{m:>12} GC closed QD {CLOSED_GC_QD} ({label}): host wall "
                  f"{wall:.3f} s on {smi}; {s.throughput_iops:.3f} IOPS, "
                  f"mean {s.mean_us:.3f} us = wait "
                  f"{s.hostq_wait_mean_us:.3f} + device "
                  f"{s.device_mean_us:.3f} + {overhead:g}, read p99 "
                  f"{s.read_p99_us:.3f} us, read device p99 "
                  f"{s.read_device_p99_us:.3f} us, WA {s.wa:.4f}; cache: "
                  f"{s.cache_absorbed_writes} writes absorbed, "
                  f"{s.cache_hit_reads} reads and {s.cache_hit_pages} pages "
                  f"hit, {s.cache_flush_pages} pages flushed, "
                  f"{s.cache_stalled_writes} writes stalled", flush=True)
    for m in CLOSED_GC_MECHANISMS:
        a, b = gc_cells[(m, "no cache")][0], gc_cells[(m, "host cache")][0]
        if (a.wa, a.blocks_erased) != (b.wa, b.blocks_erased):
            raise AssertionError(f"GC {m}: the cache changed the FTL's work")
    if K.launches != 0:
        raise AssertionError(f"closed cells launched the shard core "
                             f"{K.launches} times")
    print(f"GC cell ({GC_WORKLOAD}, {N_REQUESTS} requests): "
          f"build_ftl_schedule {ftl_s:.3f} s on {smi}; the closed cells "
          f"launched no kernel", flush=True)
    print(smi)
    summary = dict(
        golden_s=golden_s, open_s=open_s, launches=launches,
        smem_launches=smem_launches,
        held_ms=sum(r["ms"] for r in held),
        held_plain_ms=sum(r["plain_ms"] for r in held),
        ladder_walls_s=walls,
        ladder_iops={m: [s.throughput_iops for s in r]
                     for m, r in ladder.items()},
        deep_s=deep_s, gc_ftl_s=ftl_s,
        gc={f"{m} {label}": dict(
            wall_s=w, iops=s.throughput_iops, mean_us=s.mean_us,
            wait_us=s.hostq_wait_mean_us, device_us=s.device_mean_us,
            read_p99_us=s.read_p99_us,
            absorbed=s.cache_absorbed_writes, hit_pages=s.cache_hit_pages,
            flush_pages=s.cache_flush_pages,
            stalled=s.cache_stalled_writes)
            for (m, label), (s, w) in gc_cells.items()},
        card=smi)
    print("closed loop summary: " + json.dumps(summary), flush=True)
    return launches, held


# -- online GC and faults: host interpreter runs on the card's tables -------


def _golden_host_cells():
    """The pinned cells of ``golden_closed_loop.json`` the batched engine
    refuses for online GC or faults: ``(meta, {key: pinned})``."""
    g = json.loads(CLOSED_GOLDEN.read_text())
    cells = {k: v for k, v in g["cells"].items()
             if k.split("|")[2] == "online" or not k.endswith("|none")}
    if len(cells) != 20:
        raise AssertionError(f"{CLOSED_GOLDEN}: {len(cells)} online or "
                             f"fault cells")
    return g["meta"], cells


def _online_fault_runs(device):
    """The paper-size runs of phase 13 on ``device``'s characterization:
    ``{name: (stats, host seconds)}``, with the prefill skips of each
    online run's controller under ``name + " prefill_skips"``.  Every run is
    host interpreter work; the card characterizes the worn bins and the
    fault model's condition records."""
    from repro_torch.flashsim import (FaultConfig, OperatingCondition,
                                      compare_mechanisms, simulate)
    from repro_torch.flashsim import ssd as S

    meta, _ = _golden_host_cells()
    cond = OperatingCondition(*CONDITION)
    fc = FaultConfig(**meta["fault_configs"]["fc"])
    controllers = []
    controller = S.OnlineGC

    class RecordingGC(controller):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            controllers.append(self)

    runs = {}

    def timed(name, fn):
        n = len(controllers)
        t0 = time.perf_counter()
        out = fn()
        runs[name] = (out, time.perf_counter() - t0)
        runs[name + " prefill_skips"] = [d.prefill_skips
                                         for d in controllers[n:]]
        return out

    S.OnlineGC = RecordingGC
    try:
        kw = dict(n_requests=N_REQUESTS, device=device)
        timed("online compare", lambda: compare_mechanisms(
            GC_WORKLOAD, cond, MECHANISMS, gc="online", engine="auto",
            **kw))
        timed("online shard", lambda: simulate(
            GC_WORKLOAD, cond, FAULT_MECHANISM, gc="online", shard=True,
            **kw))
        for gc in ("online", "prepass"):
            timed(f"fc {gc}", lambda gc=gc: simulate(
                GC_WORKLOAD, cond, FAULT_MECHANISM, gc=gc, faults=fc, **kw))
        timed(f"fc prepass QD {FAULT_QD}", lambda: simulate(
            GC_WORKLOAD, cond, FAULT_MECHANISM, gc="prepass", faults=fc,
            ncq_depth=FAULT_QD, **kw))
        rc = dict(RECOVERY_CELL)
        rkw = dict(seed=rc.pop("seed"), gc="online", device=device,
                   faults=FaultConfig(**RECOVERY_FAULTS), **rc)
        wl = rkw.pop("workload")
        for shard in (False, True):
            timed(f"recovery shard={shard}", lambda shard=shard: simulate(
                wl, cond, FAULT_MECHANISM, shard=shard, **rkw))
        for name, faults in (("guard faults", FaultConfig()),
                             ("guard none", None)):
            timed(name, lambda faults=faults: compare_mechanisms(
                WORKLOAD, cond, MECHANISMS, faults=faults, engine="array",
                **kw))
    finally:
        S.OnlineGC = controller
    return runs


def _online_fault_digits(runs):
    """The simulated numbers of :func:`_online_fault_runs`, one line a
    run (what PERF.md predicts and the card must print)."""
    lines = []
    for m, s in runs["online compare"][0].items():
        lines.append(f"online {m}: WA {s.wa!r}, {s.gc_invocations} GC "
                     f"passes, {s.write_stalls} write stalls, read mean "
                     f"{s.read_mean_us!r} us, read p99 {s.read_p99_us!r} us")
    lines.append(f"online prefill skips by mechanism: "
                 f"{runs['online compare prefill_skips']}")
    for name in ("fc online", "fc prepass", f"fc prepass QD {FAULT_QD}",
                 "recovery shard=False"):
        s = runs[name][0]
        lines.append(f"{name}: " + ", ".join(
            f"{f} {getattr(s, f)}" for f in FAULT_FIELDS)
            + f", recovery p99 {s.recovery_p99_us!r} us, read mean "
            f"{s.read_mean_us!r} us, read p99 {s.read_p99_us!r} us, WA "
            f"{s.wa!r}")
    for m, s in runs["guard faults"][0].items():
        n = runs["guard none"][0][m]
        lines.append(f"guard {m}: {s.mispredicted_reads} mispredicted, "
                     f"read mean {s.read_mean_us!r} us (no faults "
                     f"{n.read_mean_us!r}), read p99 {s.read_p99_us!r} us "
                     f"(no faults {n.read_p99_us!r})")
    return lines


@phase("online GC and faults")
def online_faults_phase(smi, prepass, inplace):
    import torch

    from repro_torch.core import characterize as CH
    from repro_torch.core.retry import RetryPolicy
    from repro_torch.flashsim import (BatchedUnsupported, FaultConfig,
                                      FaultModel, OperatingCondition,
                                      SSDConfig, SSDSim, runtime as RT,
                                      simulate)
    from repro_torch.kernels.fcfs_core import ops as K

    print(smi, flush=True)
    t_phase = time.perf_counter()
    cond = OperatingCondition(*CONDITION)
    meta, cells = _golden_host_cells()
    K.launches = 0
    t0 = time.perf_counter()
    for key in sorted(cells):
        mech, sched, gc, fname = key.split("|")
        fcfg = meta["fault_configs"][fname]
        kw = dict(seed=meta["seed"], n_requests=meta["n_requests"],
                  scheduler=sched, gc=gc, device=DEVICE,
                  faults=None if fcfg is None else FaultConfig(**fcfg))
        wl = (meta["extra_workload"] if mech in ("baseline", "sota+pr2ar2")
              else meta["workload"])
        array = simulate(wl, cond, mech, engine="array", **kw)
        auto = simulate(wl, cond, mech, engine="auto", **kw)
        _check_pinned(f"{key}[array]", array, cells[key])
        if _outcome(auto) != _outcome(array) or \
                auto.engine_selected != "array" or \
                not auto.engine_fallback_reason or auto.fast_path_events:
            raise AssertionError(f"{key}[auto]: {auto} against the array "
                                 f"run {array}")
        try:
            simulate(wl, cond, mech, engine="batched", **kw)
            raise AssertionError(f"{key}: engine='batched' ran")
        except BatchedUnsupported as e:
            if str(e) != auto.engine_fallback_reason:
                raise AssertionError(f"{key}: batched refused with {e!r}, "
                                     f"auto recorded "
                                     f"{auto.engine_fallback_reason!r}")
    golden_s = time.perf_counter() - t0
    golden_launches = K.launches
    if golden_launches != 0:
        raise AssertionError(f"golden online/fault cells launched the shard "
                             f"core {golden_launches} times")
    print(f"online GC and faults: {len(cells)} pinned cells of "
          f"{CLOSED_GOLDEN.name} (online|none, online|fc, off|fc, "
          f"prepass|fc) equal to their pins on the card's characterization "
          f"({CLOSED_ULPS} ulps on die_util and channel_util) through "
          f"engine='array' and 'auto' (fallback recorded, "
          f"{golden_launches} shard-core launches); engine='batched' "
          f"refuses each: {golden_s:.3f} s", flush=True)

    runs = _online_fault_runs(DEVICE)
    torch.cuda.synchronize()
    if K.launches != 0:
        raise AssertionError(f"online/fault runs launched the shard core "
                             f"{K.launches} times")
    online, online_s = runs["online compare"]
    skips = runs["online compare prefill_skips"]
    for m in MECHANISMS:
        o, g, p = online[m], prepass[m], inplace[m]
        if not (o.wa > 1.0 and o.gc_invocations > 0 and o.blocks_erased > 0
                and o.engine_selected == "array"
                and "online GC" in o.engine_fallback_reason):
            raise AssertionError(f"online {m}: {o}")
        print(f"{m:>12}: online WA {o.wa:.4f}, {o.gc_invocations} GC passes, "
              f"{o.write_stalls} write stalls, {skips[MECHANISMS.index(m)]} "
              f"prefill skips, read mean {o.read_mean_us:.3f} us, read p99 "
              f"{o.read_p99_us:.3f} us | prepass WA {g.wa:.4f}, "
              f"{g.gc_invocations} GC passes, read mean "
              f"{g.read_mean_us:.3f} us, read p99 {g.read_p99_us:.3f} us | "
              f"in place read mean {p.read_mean_us:.3f} us, read p99 "
              f"{p.read_p99_us:.3f} us", flush=True)
    shard, shard_s = runs["online shard"]
    if _outcome(shard) != _outcome(online[FAULT_MECHANISM]):
        raise AssertionError(f"online {FAULT_MECHANISM}: shard=True differs "
                             f"from the monolithic run")
    print(f"online compare ({GC_WORKLOAD}, {N_REQUESTS} requests, six "
          f"mechanisms): host wall {online_s:.3f} s on {smi}; "
          f"{FAULT_MECHANISM} shard=True == monolithic ({shard_s:.3f} s)",
          flush=True)

    fo, fp, fq = (runs[k][0] for k in ("fc online", "fc prepass",
                                       f"fc prepass QD {FAULT_QD}"))
    for f in FAULT_FIELDS:
        if getattr(fq, f) != getattr(fp, f):
            raise AssertionError(f"fc prepass QD {FAULT_QD}: {f} "
                                 f"{getattr(fq, f)} against the open loop's "
                                 f"{getattr(fp, f)}")
    if not (fq.max_inflight <= FAULT_QD and fp.mispredicted_reads > 0
            and fo.mispredicted_reads > 0 and fo.write_stalls > 0):
        raise AssertionError(f"fc runs: online {fo}, prepass {fp}, closed "
                             f"{fq}")
    rec, rec_s = runs["recovery shard=False"]
    if not (rec.parity_rebuilds > 0 and rec.rebuild_reads > 0
            and rec.retired_blocks > 0):
        raise AssertionError(f"recovery cell: no rebuild or retirement: {rec}")
    if _outcome(runs["recovery shard=True"][0]) != _outcome(rec):
        raise AssertionError("recovery cell: shard=True differs")
    guard = runs["guard faults"][0]
    for m, s in guard.items():
        if not RetryPolicy(m).adaptive_tr and s.mispredicted_reads:
            raise AssertionError(f"guard {m}: a non-adaptive mechanism "
                                 f"mispredicted {s.mispredicted_reads} reads")
    if not any(s.mispredicted_reads for s in guard.values()):
        raise AssertionError("guard: no adaptive mechanism mispredicted")
    for line in _online_fault_digits(runs):
        print(line, flush=True)
    # The derived rates rest on the card's characterization record (its
    # float32 margin mean, ROADMAP C10), not on the simulation.
    st = CH.characterize_condition(*CONDITION, device=DEVICE)
    fm = FaultModel(FaultConfig(), SSDConfig(), cond,
                    RetryPolicy(FAULT_MECHANISM), 7,
                    SSDSim(SSDConfig(), cond, RetryPolicy(FAULT_MECHANISM),
                           device=DEVICE))
    print(f"fault model at {CONDITION[0]:g} d / {CONDITION[1]:g} P/E on the "
          f"card: mean_margin_final {st.mean_margin_final!r}, "
          f"{FAULT_MECHANISM} p_mis {fm.p_mis(0.0)!r}, p_unc "
          f"{fm.p_unc(0.0)!r} (pinned CPU values {PIN_P_MIS!r}, "
          f"{PIN_P_UNC!r})", flush=True)
    if (fm.p_mis(0.0), fm.p_unc(0.0)) != (PIN_P_MIS, PIN_P_UNC):
        raise AssertionError("the card's fault rates differ from the CPU's")
    walls = {k: v[1] for k, v in runs.items() if not k.endswith("skips")}
    print(f"host wall by run on {smi}: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in walls.items()), flush=True)

    conds = tuple(OperatingCondition(*c) for c in SWEEP_CONDITIONS)
    blobs, sweep_s = {}, {}
    for w in (1, 2):
        t0 = time.perf_counter()
        out = RT.run_sweep(GC_WORKLOAD, conds, GC_PRIO_MECHANISMS,
                           ONLINE_SWEEP_SEEDS, n_requests=ONLINE_SWEEP_N,
                           gc="online",
                           faults=FaultConfig(**meta["fault_configs"]["fc"]),
                           workers=w, device=DEVICE)
        sweep_s[w] = time.perf_counter() - t0
        if any(s.fused_cells or s.fast_path_events or s.n_requests !=
               ONLINE_SWEEP_N for s in out.values()):
            raise AssertionError(f"online sweep workers={w}: {out}")
        blobs[w] = RT.sweep_to_json(out)
    if blobs[1] != blobs[2]:
        raise AssertionError("online/fault sweep: sweep_to_json differs "
                             "between workers 1 and 2")
    phase_s = time.perf_counter() - t_phase
    print(f"online/fault sweep ({GC_WORKLOAD}, {ONLINE_SWEEP_N} requests, "
          f"{len(conds)} conditions x {len(GC_PRIO_MECHANISMS)} mechanisms x "
          f"seeds {ONLINE_SWEEP_SEEDS}, fc): workers 1 {sweep_s[1]:.3f} s, "
          f"workers 2 (spawned) {sweep_s[2]:.3f} s, sweep_to_json "
          f"byte-identical ({len(blobs[1])} bytes); phase {phase_s:.3f} s "
          f"of its {ONLINE_BUDGET_S:g} s budget", flush=True)
    if phase_s > ONLINE_BUDGET_S:
        print(f"online GC and faults: {phase_s:.1f} s, OVER the "
              f"{ONLINE_BUDGET_S:g} s budget", flush=True)
    print(smi)
    summary = dict(golden_s=golden_s, golden_launches=golden_launches,
                   walls_s=walls, sweep_s=sweep_s, phase_s=phase_s,
                   online_wa={m: online[m].wa for m in MECHANISMS},
                   online_write_stalls={m: online[m].write_stalls
                                        for m in MECHANISMS},
                   card=smi)
    print("online GC and faults summary: " + json.dumps(summary), flush=True)
    return K.launches + golden_launches


def _kernel_counts():
    """Every kernel wrapper's launch count in this process (B1-B5)."""
    from repro_torch.kernels.fcfs_core import ops as B1
    from repro_torch.kernels.flash_attention import ops as B4
    from repro_torch.kernels.kv_retry import ops as B5
    from repro_torch.kernels.rber import ops as B3
    from repro_torch.kernels.ssd_scan import ops as B2

    return dict(fcfs_core=B1.launches, flash_attention=B4.launches,
                kv_retry=B5.launches, ssd_scan=B2.launches,
                rber=B3.launches)


def _launched_since(before):
    now = _kernel_counts()
    return {k: now[k] - before[k] for k in now}


def _hold_metrics(what, m, pins, margins, margins_sha):
    """Hold the card's metrics ``m`` (already equal to this host's CPU
    run's) to the pinned CPU run: every metric but the two numpy ones
    exactly; the numpy ones through their input, ``margins`` (the card's
    worst-condition margins), whose digest must be the pin's and whose
    host numpy mean and 1st percentile must be ``m``'s.  Returns the
    metrics that differ from their pins, as (host value, pin)."""
    import hashlib

    import numpy as np

    bad = {k: (v, pins[k]) for k, v in m.items()
           if v != pins[k] and k not in HOST_NUMPY_METRICS}
    if bad or set(m) != set(pins):
        raise AssertionError(f"{what} differs from the pinned CPU run: "
                             f"{bad}")
    sha = hashlib.sha256(margins.tobytes()).hexdigest()
    if margins.dtype != np.float32 or sha != margins_sha:
        raise AssertionError(f"{what}: worst margins {margins.dtype} "
                             f"sha256 {sha} != pinned {margins_sha}")
    host = dict(t2_margin_mean=float(margins.mean()),
                t2_margin_p01=float(np.percentile(margins, 1)))
    if host != {k: m[k] for k in HOST_NUMPY_METRICS}:
        raise AssertionError(f"{what}: host numpy reduces the margins to "
                             f"{host}, evaluate gave {m}")
    return {k: (m[k], pins[k]) for k in HOST_NUMPY_METRICS
            if m[k] != pins[k]}


@phase("calibrate")
def calibrate_phase(smi):
    """``evaluate(DEFAULT_NAND)`` on the card equals the CPU's on this
    host and the pinned CPU metrics (the two numpy-reduced ones through
    their input margins); the 108-set grid runs when it fits its budget,
    and its best set and metrics are the pinned CPU run's."""
    import numpy as np
    import torch

    from repro_torch.core import calibrate as CAL
    from repro_torch.core import constants as C

    before = _kernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = CAL.evaluate(C.DEFAULT_NAND, device=DEVICE)
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_cpu = CAL.evaluate(C.DEFAULT_NAND, device="cpu")
    cpu_s = time.perf_counter() - t0
    m, m_cpu = ({k: float(v) for k, v in d.items()} for d in (m, m_cpu))
    if m != m_cpu:
        raise AssertionError(f"evaluate card {m} != cpu {m_cpu}")
    off = _hold_metrics("evaluate(DEFAULT_NAND)", m, PIN_EVALUATE,
                        CAL.worst_margins(C.DEFAULT_NAND, device=DEVICE),
                        PIN_EVALUATE_MARGINS)
    print(f"evaluate(DEFAULT_NAND): card {eval_s:.3f} s, cpu {cpu_s:.3f} s "
          f"on {smi}; 9 metrics equal card to cpu, 7 to the pins, the "
          f"worst margins' digest to the pin; host numpy {np.__version__}: "
          + ", ".join(f"{k} {m[k]!r} (pinned {PIN_EVALUATE[k]!r})"
                      for k in HOST_NUMPY_METRICS)
          + f"; differing from the pins: {off or 'none'}", flush=True)
    out = dict(evaluate_s=eval_s, cpu_s=cpu_s, grid_s=None)
    if 108 * eval_s <= CALIBRATE_GRID_BUDGET_S:
        t0 = time.perf_counter()
        score, best, bm = CAL.main(device=DEVICE, verbose=False)
        out["grid_s"] = time.perf_counter() - t0
        score = float(score)
        got = dict(alpha_r=best.alpha_r, sigma_r=best.sigma_r,
                   sense_eta=best.sense_eta, retry_step_v=best.retry_step_v)
        if got != PIN_GRID_BEST:
            raise AssertionError(f"grid best {got} != CPU's {PIN_GRID_BEST}")
        bm = {k: float(v) for k, v in bm.items()}
        bm_cpu = {k: float(v) for k, v in
                  CAL.evaluate(best, device="cpu").items()}
        if bm != bm_cpu or score != CAL.score(bm_cpu):
            raise AssertionError(f"grid best card {score!r} {bm} != this "
                                 f"host's cpu {bm_cpu}")
        off = _hold_metrics("grid best", bm, PIN_GRID_METRICS,
                            CAL.worst_margins(best, device=DEVICE),
                            PIN_GRID_MARGINS)
        if CAL.score(PIN_GRID_METRICS) != PIN_GRID_SCORE or \
                (not off and score != PIN_GRID_SCORE):
            raise AssertionError(f"grid score {score!r}, pinned "
                                 f"{PIN_GRID_SCORE!r}")
        print(f"108-set grid on the card: {out['grid_s']:.3f} s; best "
              f"{got}, the pinned CPU's; 9 metrics equal card to this "
              f"host's cpu, 7 to the pins, the worst margins' digest to "
              f"the pin; score {score!r} (pinned {PIN_GRID_SCORE!r}); "
              f"differing from the pins (host numpy {np.__version__}'s "
              f"reduction of the pinned margins, value vs pin): "
              f"{off or 'none'}", flush=True)
    else:
        print(f"108-set grid skipped: about {108 * eval_s:.0f} s > "
              f"{CALIBRATE_GRID_BUDGET_S:.0f} s budget", flush=True)
    launched = _launched_since(before)
    print(f"kernel launches in the phase: {launched}", flush=True)
    if any(launched.values()):
        raise AssertionError("calibration launched a kernel")
    return out


def _device_busy(fn, top=6):
    """(wall s, device-busy s, top kernels, skew ms) of ``fn()`` under
    ``torch.profiler``.  Busy is the union of the intervals of the
    device's kernels, copies and sets, None when the profiler sees none;
    the profiler's user annotations, which it mirrors onto the device's
    timeline across whole ranges (a ``record_function`` around ``fn``
    marks the window), are not device work.  Top is the ``top`` kernels
    by summed device time as (name, ms, count); skew the device events'
    first start and last end relative to the window's on the profiler's
    clock.  Raises when busy exceeds the wall: the device cannot be busy
    longer than the window it ran in."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    window = "chip_smoke.window"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(window):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    spans, by_name, win = [], {}, None
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            if ev.name == window:
                win = ev.time_range
            continue
        if getattr(ev, "is_user_annotation", False) or ev.name == window:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        ms, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3, n + 1)
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy = busy / 1e6 if spans else None
    if busy is not None and busy > wall:
        raise AssertionError(f"device busy {busy:.6f} s > wall {wall:.6f} s"
                             f": the profiler's intervals are not the "
                             f"device's")
    skew = None
    if spans and win is not None:
        skew = ((min(a for a, _ in spans) - win.start) / 1e3,
                (max(b for _, b in spans) - win.end) / 1e3)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return wall, busy, [(name[:60], ms, n) for name, (ms, n) in ranked], \
        skew


@phase("train")
def train_phase(smi):
    """llama3.2-3b trained at its published widths on the card: the loss
    is finite and falls; a depth-cut copy saves with a corrupt shard,
    restores bit for bit, and resumes to the uninterrupted run's losses
    (deterministic algorithms on); the flash tier's stats equal the
    CPU's; no kernel launches."""
    import dataclasses

    import torch

    from repro_torch.checkpoint import corrupt_shard, restore
    from repro_torch.configs import get_config
    from repro_torch.launch import train as TL
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves

    before = _kernel_counts()
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    quiet = lambda *_: None      # noqa: E731
    cfg = get_config(TRAIN_ARCH)
    n_params = cfg.n_params()
    print(f"{TRAIN_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.resolved_head_dim}"
          f", ff {cfg.d_ff}, vocab {cfg.vocab}: {n_params / 1e9:.3f} B "
          f"parameters, {16 * n_params / 1e9:.1f} GB of f32 parameters, "
          f"gradients and moments", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt = AdamWConfig(lr=TRAIN_LR, moment_dtype=cfg.moment_dtype)
    run = TL.train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                   device=DEVICE, opt=opt, log=quiet)
    wall = time.perf_counter() - t0
    losses = [run.losses[i] for i in sorted(run.losses)]
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses}")
    stats = dataclasses.asdict(run.reader.stats)
    if stats != PIN_FLASH_STATS:
        raise AssertionError(f"flash tier stats {stats} != CPU's "
                             f"{PIN_FLASH_STATS}")
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in
             run.reader.corpus.batch(TRAIN_STEPS).items()}
    model_loss = TL.build_model(cfg, DEVICE).train_loss
    step_wall, busy, top, skew = _device_busy(lambda: TL.train_step(
        model_loss, run.state, batch, opt, 0.1))
    peak = torch.cuda.max_memory_allocated() / 1e9
    steady = run.step_s[1:]
    busy_txt = "not measured" if busy is None else \
        f"{busy:.3f} s ({busy / step_wall:.1%})"
    if skew is not None:
        busy_txt += (f" (device events from {skew[0]:+.3f} ms after the "
                     f"window starts to {skew[1]:+.3f} ms after it ends, "
                     f"on the profiler clock)")
    print(f"train {TRAIN_ARCH} full depth, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, {TRAIN_STEPS} steps on {smi}: losses {losses}; "
          f"{wall:.3f} s in all, step {sum(steady) / len(steady):.3f} s "
          f"(steps 2-{TRAIN_STEPS}; first {run.step_s[0]:.3f} s), profiled "
          f"step {step_wall:.3f} s with device busy {busy_txt}, peak {peak:.1f} GB allocated; input stall "
          f"{run.pipeline.stall_s:.3f} s; flash tier {stats}, the CPU's",
          flush=True)
    print("  profiled step's device time by kernel: " + "; ".join(
        f"{n} {ms:.1f} ms x{c}" for n, ms, c in top), flush=True)
    out = dict(losses=losses, step_s=sum(steady) / len(steady),
               busy=busy, step_wall=step_wall, peak_gb=peak)
    del run, batch, model_loss
    torch.cuda.empty_cache()

    ccfg = dataclasses.replace(cfg, n_layers=CKPT_LAYERS)
    kw = dict(steps=CKPT_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
              device=DEVICE, opt=opt, log=quiet)
    whole = TL.train(ccfg, **kw)
    whole.state = None
    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    first = TL.train(ccfg, ckpt_dir=ckdir, save_every=CKPT_AT,
                     stop_after=CKPT_AT, **kw)
    d = ckdir / f"step_{CKPT_AT:09d}"
    n_shards = len(list(d.glob("shard_*.bin")))
    corrupt_shard(d, n_shards // 2)
    restored, rst = restore(d, first.state, device=DEVICE)
    pairs = list(zip(tree_leaves(restored), tree_leaves(first.state)))
    if rst.n_reconstructed < 1 or not all(
            torch.equal(a, b.detach()) for a, b in pairs):
        raise AssertionError(f"restore not bitwise or nothing "
                             f"reconstructed: {rst}")
    del restored, pairs, first.state
    torch.cuda.empty_cache()
    resumed = TL.train(ccfg, ckpt_dir=ckdir, save_every=10 ** 9, **kw)
    want = [whole.losses[i] for i in range(1, CKPT_STEPS + 1)]
    got = [first.losses[i] if i <= CKPT_AT else resumed.losses[i]
           for i in range(1, CKPT_STEPS + 1)]
    if resumed.start_step != CKPT_AT or got != want or \
            resumed.restore_stats.n_reconstructed < 1:
        raise AssertionError(f"resume from step {resumed.start_step}: "
                             f"losses {got} != uninterrupted {want}")
    gb = sum(f.stat().st_size for f in d.iterdir()) / 1e9
    print(f"checkpoint round trip at {CKPT_LAYERS} layer(s), full widths "
          f"({gb:.2f} GB on disk, {n_shards} shards, shard {n_shards // 2} "
          f"corrupted): save {first.save_s[0]:.3f} s, restore wall "
          f"{rst.wall_s:.3f} s (read {rst.read_s:.3f} s, verify "
          f"{rst.verify_s:.3f} s, {rst.n_reconstructed} reconstructed), "
          f"bitwise; resume at step {CKPT_AT}: losses {got} equal the "
          f"uninterrupted run's bit for bit", flush=True)
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.use_deterministic_algorithms(False)
    launched = _launched_since(before)
    print(f"kernel launches in the phase: {launched} (none expected: "
          f"training attention is blockwise autograd)", flush=True)
    if any(launched.values()):
        raise AssertionError("the training path launched a kernel")
    out.update(save_s=first.save_s[0], restore=dataclasses.asdict(rst))
    return out


def _zero_pages(store):
    """All-zero pages of a store's KV leaves (a local layer's ring, left
    padded below its window): B3's read of each such leaf against its
    plain version, margins finite and equal within the hold's rtol, the
    same decisions.  Returns (zero pages, of them fast, margin)."""
    import torch

    from repro_torch.kernels.kv_retry import ops as KV
    from repro_torch.kernels.kv_retry.plain import kv_retry_plain
    from repro_torch.serving.kv_store import _leaves as store_leaves
    from repro_torch.serving.kv_store import keystr

    n = fast = 0
    margins = []
    for path, leaf in store_leaves(store.backing):
        if keystr(path) not in store.fast:
            continue
        q, sc = store.fast[keystr(path)]
        backing = leaf.reshape(-1, leaf.shape[-1])
        zero = ~backing.any(dim=-1)
        if not bool(zero.any()):
            continue
        out, m = KV.kv_retry_fwd(q, sc, backing, store.tau)
        want, wm = kv_retry_plain(q, sc, backing, store.tau)
        m, wm = m[zero, 0], wm[zero, 0]
        gap = float(((m.double() - wm.double()).abs() / torch.maximum(
            wm.abs(), (1 - wm).abs()).double()).max())
        if not bool(torch.isfinite(m).all()) or gap > KV_MARGIN_RTOL or \
                not torch.equal(m >= 0, wm >= 0) or bool(out[zero].any()):
            raise AssertionError(f"{keystr(path)}: B3 on all-zero pages: "
                                 f"margins {m.unique().tolist()} against "
                                 f"{wm.unique().tolist()}")
        n += int(zero.sum())
        fast += int((m >= 0).sum())
        margins.append(m)
    return n, fast, (torch.cat(margins).unique().tolist() if margins else [])


@phase("recurrent and MoE serve path")
def family_phase(smi):
    """recurrentgemma-2b and olmoe-1b-7b served at full width and depth
    (each B4 and B3 launch held), the small-width card-against-CPU checks
    of the RG-LRU and MoE configs, and a few training steps of each at
    full widths and cut depths."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ATTN, LOCAL
    from repro_torch.launch import train as TL
    from repro_torch.launch.serve import default_prompts
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves

    for arch, kw in FAMILY_SMALL:
        _small_width_check(arch, 0.9, **kw)

    launches = dict.fromkeys(("flash_attention", "flash_attention_tc",
                              "kv_retry", "kv_retry_vec"), 0)
    held = {"flash_attention": [], "kv_retry": []}
    for arch in FAMILY_ARCHS:
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        print(f"{arch}: {cfg.n_layers} layers, {cfg.unit_count()} units of "
              f"{cfg.block_pattern} and a tail of {cfg.tail_pattern()}",
              flush=True)
        kinds = list(cfg.block_pattern) * cfg.unit_count() + list(
            cfg.tail_pattern())
        n_attn = sum(k in (ATTN, LOCAL) for k in kinds)
        engines, n_params, got, got_held, out = _serve_full_width(
            arch, prefix=f"{arch} ")
        for label, (_, st, counts) in out.items():
            kv_want = 0 if label.endswith("baseline") else \
                2 * (SERVE_MAX_NEW - 1)
            if counts["flash_attention"] != n_attn or \
                    counts["kv_retry"] != kv_want or counts["ssd_scan"]:
                raise AssertionError(f"{label}: launches {counts}; one "
                                     f"prefill of {n_attn} attention "
                                     f"layers and {kv_want} KV leaf reads "
                                     f"expected")
        for k in launches:
            launches[k] += got[k]
        for k in held:
            held[k] += got_held[k]
        r_st = out[f"{arch} short pr2ar2 tau {RETRY_TAU}"][1]
        zero, zero_fast, zero_m = _zero_pages(engines["retry"].store)
        short = max(len(p) for p in default_prompts(cfg.vocab, 4))
        if LOCAL in kinds and short < cfg.window and not zero > 0:
            raise AssertionError(f"{arch}: no all-zero KV pages in the "
                                 f"retry store, though its short prompts "
                                 f"({short} tokens at most) leave a local "
                                 f"ring of window {cfg.window} padded")
        print(f"{arch} on {smi}: {n_params} parameters, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
              f"(peak {torch.cuda.max_memory_allocated() / 2**30:.2f}); "
              + "; ".join(f"{lab.split(' ', 1)[1]} prefill "
                          f"{st.prefill_s * 1e3:.1f} ms decode "
                          f"{st.decode_s * 1e3:.1f} ms"
                          for lab, (_, st, _) in out.items())
              + f"; B4 {got['flash_attention']} launches "
              f"(tc_launches {got['flash_attention_tc']}), B3 "
              f"{got['kv_retry']} (vec_launches {got['kv_retry_vec']}); "
              f"retry run {r_st.kv.retried_pages} of {r_st.kv.pages} page "
              f"reads retried; {zero} all-zero KV pages in the retry "
              f"store, {zero_fast} of them fast on B3 and its plain version "
              f"alike (margins {zero_m})", flush=True)
        del engines, out, got_held
        gc.collect()
        torch.cuda.empty_cache()

    before = _kernel_counts()
    quiet = lambda *_: None      # noqa: E731
    train = {}
    for arch, n_layers in FAMILY_TRAIN:
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        opt = AdamWConfig(lr=TRAIN_LR, moment_dtype=cfg.moment_dtype)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = TL.train(cfg, steps=FAMILY_TRAIN_STEPS, batch=TRAIN_BATCH,
                       seq=TRAIN_SEQ, device=DEVICE, opt=opt, log=quiet)
        wall = time.perf_counter() - t0
        losses = [run.losses[i] for i in sorted(run.losses)]
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"train {arch}: losses {losses}")
        n_params = sum(t.numel() for t in tree_leaves(run.state["params"]))
        print(f"train {arch} at full widths, {n_layers} layers "
              f"({cfg.unit_count()} unit(s), tail {cfg.tail_pattern()}), "
              f"{n_params} parameters, batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
              f"{FAMILY_TRAIN_STEPS} steps on {smi}: losses {losses}"
              f"{' (with 0.01 x the aux loss)' if cfg.moe else ''}; "
              f"{wall:.3f} s in all, steps "
              f"{[round(t, 3) for t in run.step_s]} s, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB allocated",
              flush=True)
        train[arch] = dict(losses=losses, step_s=run.step_s)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    launched = _launched_since(before)
    if any(launched.values()):
        raise AssertionError(f"the training path launched a kernel: "
                             f"{launched}")
    return launches, held, train


def _encdec_launches(cfg):
    """Flash-attention launches a prefill and KV leaves a decode step of
    an encoder-decoder or VLM config: whisper runs its encoder's
    bidirectional layers and each decoder layer's causal and cross
    attention, and reads the self and cross k and v leaves; internvl one
    causal launch a layer, and the k and v leaves."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers, 4
    return cfg.n_layers, 2


def _cross_leaf_report(store):
    """``quantize_pages`` of one static cross leaf, which the KV store
    re-runs on it every decode step (a measurement beside B3, not a
    kernel of the port), and B3's read of it, timed on the card."""
    from repro_torch.kernels.kv_retry import ops as KV
    from repro_torch.kernels.kv_retry.plain import quantize_pages

    leaf = store.backing["units"]["b0"]["xattn"]["k"]
    pages = leaf.reshape(-1, leaf.shape[-1])
    quantize_pages(pages)                                 # warm-up
    quant_ms, (q, sc) = _cuda_ms(lambda: quantize_pages(pages), KERNEL_REPS)
    KV.kv_retry_fwd(q, sc, pages, store.tau)              # warm-up
    read_ms, _ = _cuda_ms(lambda: KV.kv_retry_fwd(q, sc, pages, store.tau),
                          KERNEL_REPS)
    print(f"cross leaf {tuple(leaf.shape)} {leaf.dtype} "
          f"({pages.numel() * pages.element_size() / 1e6:.1f} MB, "
          f"{pages.shape[0]} pages): quantize_pages {quant_ms:.4f} ms, B3's "
          f"read {read_ms:.4f} ms", flush=True)


def _fa_modes(held):
    """Held flash-attention launches summed by mode: bidirectional (T =
    S), cross (T != S) and causal."""
    modes = {}
    for r in held:
        mode = "causal" if r["causal"] else (
            "bidir" if r["T"] == r["S"] else "cross")
        modes.setdefault(mode, []).append(r)
    return modes


def _train_random_patches(cfg, opt, seq):
    """The launcher's train step on the corpus's batches with seeded
    random patch embeddings in place of its zeros: (losses, step
    seconds)."""
    import torch

    from repro_torch.data import CorpusConfig, SyntheticCorpus
    from repro_torch.launch import train as TL
    from repro_torch.models import build_model

    state = TL.make_state(cfg, DEVICE, seed=0, opt=opt)
    model = build_model(cfg, DEVICE)
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seq_len=seq,
                                          batch=TRAIN_BATCH))
    gen = torch.Generator(DEVICE).manual_seed(0)
    losses, step_s = [], []
    for i in range(FAMILY_TRAIN_STEPS):
        b = {k: torch.as_tensor(v, device=DEVICE)
             for k, v in corpus.batch(i).items()}
        b["patches"] = torch.randn((TRAIN_BATCH, cfg.n_patches, cfg.d_model),
                                   generator=gen, device=DEVICE)
        t0 = time.perf_counter()
        loss = TL.train_step(model.train_loss, state, b, opt,
                             TL.cosine_schedule(i + 1, FAMILY_TRAIN_STEPS,
                                                TL.WARMUP))
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    return losses, step_s


@phase("encoder-decoder and VLM serve path")
def encdec_phase(smi):
    """whisper-large-v3 and internvl2-1b served at full width and depth
    (each B4 launch and the held B3 launches against the plain version),
    their small-width card-against-CPU checks, and a few training steps
    of each at full widths."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as TL
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves

    for arch, kw in ENCDEC_SMALL:
        _small_width_check(arch, 1.0, exact=True, **kw)

    launches = dict.fromkeys(("flash_attention", "flash_attention_tc",
                              "kv_retry", "kv_retry_vec"), 0)
    held = {"flash_attention": [], "kv_retry": []}
    for arch in ENCDEC_LONG:
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        n_fa, n_leaves = _encdec_launches(cfg)
        keep = None
        if cfg.family == "encdec":
            # A whisper decode step reads 4 leaves, two of them the
            # static cross leaves of (32, 4, 20, 1500, 64) bf16, 491.5
            # MB each: keeping every launch's int8 pages, scales, backing
            # and output would take ~3.3 GB a step, ~49 GB for the long
            # pr2ar2 run.  So the launches of the first and last decode
            # step are kept and held, the others counted.
            last = (SERVE_MAX_NEW - 2) * n_leaves
            keep = {"kv_retry": lambda i: i < n_leaves or i >= last}
        print(f"{arch}: {cfg.family}, {cfg.n_enc_layers} encoder and "
              f"{cfg.n_layers} decoder layers, d {cfg.d_model}, "
              f"{cfg.n_heads} heads over {cfg.n_kv_heads} of hd "
              f"{cfg.resolved_head_dim}; B4 {n_fa} launches a prefill, B3 "
              f"{n_leaves} a decode step", flush=True)
        engines, n_params, got, got_held, out = _serve_full_width(
            arch, prefix=f"{arch} ", long_lengths=ENCDEC_LONG[arch],
            keep=keep)
        for label, (_, st, counts) in out.items():
            kv_want = 0 if label.endswith("baseline") else \
                n_leaves * (SERVE_MAX_NEW - 1)
            if counts["flash_attention"] != n_fa or \
                    counts["kv_retry"] != kv_want or counts["ssd_scan"]:
                raise AssertionError(f"{label}: launches {counts}; one "
                                     f"prefill of {n_fa} attention "
                                     f"launches and {kv_want} KV leaf "
                                     f"reads expected")
        for k in launches:
            launches[k] += got[k]
        for k in held:
            held[k] += got_held[k]
        for mode, rs in _fa_modes(got_held["flash_attention"]).items():
            _print_held(f"{arch} B4 {mode} (T {min(r['T'] for r in rs)}-"
                        f"{max(r['T'] for r in rs)}, S "
                        f"{min(r['S'] for r in rs)}-"
                        f"{max(r['S'] for r in rs)})", rs)
        r_st = out[f"{arch} short pr2ar2 tau {RETRY_TAU}"][1]
        steps = SERVE_MAX_NEW - 1
        if cfg.family == "encdec":
            _cross_leaf_report(engines["pr2ar2"].store)
        print(f"{arch} on {smi}: {n_params} parameters, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
              f"(peak {torch.cuda.max_memory_allocated() / 2**30:.2f}); "
              + "; ".join(f"{lab.split(' ', 1)[1]} prefill "
                          f"{st.prefill_s * 1e3:.1f} ms decode "
                          f"{st.decode_s * 1e3 / steps:.1f} ms a step"
                          for lab, (_, st, _) in out.items())
              + f"; B4 {got['flash_attention']} launches "
              f"(tc_launches {got['flash_attention_tc']}), B3 "
              f"{got['kv_retry']} (vec_launches {got['kv_retry_vec']}); "
              f"retry run {r_st.kv.retried_pages} of {r_st.kv.pages} page "
              f"reads retried", flush=True)
        del engines, out, got_held
        gc.collect()
        torch.cuda.empty_cache()

    before = _kernel_counts()
    quiet = lambda *_: None      # noqa: E731
    train = {}
    for arch, cut, seq in ENCDEC_TRAIN:
        cfg = dataclasses.replace(get_config(arch), **cut)
        opt = AdamWConfig(lr=TRAIN_LR, moment_dtype=cfg.moment_dtype)
        what = (f"{cfg.n_enc_layers} encoder and {cfg.n_layers} decoder "
                f"layers, batch {TRAIN_BATCH} x {seq} tokens"
                f"{' + 1500 frames' if cfg.family == 'encdec' else ''}"
                f"{' + 256 patches' if cfg.family == 'vlm' else ''}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = TL.train(cfg, steps=FAMILY_TRAIN_STEPS, batch=TRAIN_BATCH,
                       seq=seq, device=DEVICE, opt=opt, log=quiet)
        wall = time.perf_counter() - t0
        losses = [run.losses[i] for i in sorted(run.losses)]
        n_params = sum(t.numel() for t in tree_leaves(run.state["params"]))
        print(f"train {arch} at full widths through the launcher (zero "
              f"frontend inputs), {what}, {n_params} parameters, "
              f"{FAMILY_TRAIN_STEPS} steps on {smi}: losses {losses}; "
              f"{wall:.3f} s in all, steps "
              f"{[round(t, 3) for t in run.step_s]} s, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB allocated",
              flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
        if cfg.family == "vlm":
            # ROADMAP C12: the zero patch rows stay exactly 0 through every
            # layer, each RMSNorm's backward scales their gradient by
            # 1/sqrt(1e-6), and at 24 layers it overflows, in the
            # reference as here: the first loss is finite, the step
            # writes NaN.  The training path itself is held on seeded
            # random patches.
            if not math.isfinite(losses[0]):
                raise AssertionError(f"train {arch}: losses {losses}")
            losses, step_s = _train_random_patches(cfg, opt, seq)
            print(f"train {arch} at full widths on seeded random patches, "
                  f"{what}, {FAMILY_TRAIN_STEPS} steps: losses {losses}; "
                  f"steps {[round(t, 3) for t in step_s]} s, peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB "
                  f"allocated", flush=True)
            gc.collect()
            torch.cuda.empty_cache()
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"train {arch}: losses {losses}")
        train[arch] = losses
    launched = _launched_since(before)
    if any(launched.values()):
        raise AssertionError(f"the training path launched a kernel: "
                             f"{launched}")
    return launches, held, train


def _serve_smoke_archs():
    """``python -m repro_torch.launch.serve --smoke --arch A`` in-process
    on the card for every published arch (the reduced configs: head dim
    16, E 16 KV pages), each run's B4 and B3 launches recorded, counted
    (B4 all at head dim 16, ``small_hd_launches``; B3 all on the vector
    kernel) and held against the plain version; mamba2-130m launches B5
    and reads no KV page.  Returns (launches, held)."""
    import contextlib

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.configs.base import ATTN, LOCAL, reduced_config
    from repro_torch.launch import serve as SERVE

    mods = _kernel_modules()
    fa, kv, ssd = mods["flash_attention"], mods["kv_retry"], mods["ssd_scan"]
    launches = dict.fromkeys(("flash_attention", "flash_attention_small_hd",
                              "kv_retry", "kv_retry_vec", "ssd_scan"), 0)
    held = {"flash_attention": [], "kv_retry": []}
    for arch in sorted(ARCHS):
        cfg = reduced_config(get_config(arch))
        for m in (fa, kv, ssd):
            m.launches = 0
        fa.small_hd_launches = fa.tc_launches = kv.vec_launches = 0
        recs = {"flash_attention": _Recorder(fa, "flash_attention_fwd"),
                "kv_retry": _Recorder(kv, "kv_retry_fwd")}
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for r in recs.values():
                stack.enter_context(r)
            SERVE.main(["--smoke", "--arch", arch])
        wall = time.perf_counter() - t0
        counts = dict(flash_attention=fa.launches,
                      flash_attention_small_hd=fa.small_hd_launches,
                      kv_retry=kv.launches, kv_retry_vec=kv.vec_launches,
                      ssd_scan=ssd.launches)
        has_attn = cfg.family != "decoder" or any(
            k in (ATTN, LOCAL) for k in cfg.block_pattern)
        ok = (counts["flash_attention"] == counts["flash_attention_small_hd"]
              == recs["flash_attention"].n and fa.tc_launches == 0
              and counts["kv_retry"] == counts["kv_retry_vec"]
              == recs["kv_retry"].n
              and (counts["flash_attention"] > 0) == has_attn
              and (counts["kv_retry"] > 0) == has_attn
              and (counts["ssd_scan"] > 0) == (cfg.ssm is not None))
        if not ok:
            raise AssertionError(f"serve --smoke --arch {arch}: launches "
                                 f"{counts}, tc {fa.tc_launches}")
        rs = {k: [_HOLDERS[k][1](f"smoke {arch} launch {i}", a, o)
                  for i, (a, o) in enumerate(r.calls)]
              for k, r in recs.items()}
        for k, n in counts.items():
            launches[k] += n
        for k in held:
            held[k] += rs[k]
        print(f"serve --smoke --arch {arch} on the card: {wall:.3f} s, "
              f"head dim {cfg.resolved_head_dim}, launches {counts}, all "
              f"held", flush=True)
        del recs, rs
    return launches, held


def _int8_cache_bytes(cache):
    """Bytes of an int8 cache's k/v leaves and of their scales, and what
    the same k/v leaves take in bfloat16."""
    import torch

    from repro_torch.serving.kv_store import _leaves

    data = scales = 0
    for path, leaf in _leaves(cache):
        if path[-1] in ("k", "v") and leaf.dtype == torch.int8:
            data += leaf.numel()
        elif path[-1] in ("k_s", "v_s"):
            scales += leaf.numel() * leaf.element_size()
    return data, scales, 2 * data


def _mamba_grad_check():
    """The reduced mamba2-130m's float32 loss and gradients, card against
    CPU on the same weights and batch: the loss within rtol 1e-5, every
    gradient within rtol 1e-5 plus 1e-5 of its leaf's largest magnitude
    (the tolerance of ``tests/test_torch_train.py``)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import tree_leaves, tree_map

    cfg = dataclasses.replace(reduced_config(get_config(SSM_ARCH)),
                              activation_dtype="float32")
    params = build_model(cfg, "cpu", torch.Generator().manual_seed(0)).init()
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 64))
    batch = {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(np.roll(toks, -1, axis=1))}
    out = {}
    for dev in (DEVICE, "cpu"):
        p = tree_map(lambda t: t.to(dev).requires_grad_(True), params)
        loss = build_model(cfg, dev).train_loss(
            p, {k: v.to(dev) for k, v in batch.items()})
        loss.backward()
        out[dev] = (float(loss.detach()),
                    [t.grad.cpu() for t in tree_leaves(p)])
    (lc, gc), (lp, gp) = out[DEVICE], out["cpu"]
    worst = max(float(((a - b).abs() - 1e-5 * b.abs()).max())
                / max(1e-5 * float(b.abs().max()), 1e-30)
                for a, b in zip(gc, gp))
    if abs(lc - lp) > 1e-5 * abs(lp) or not worst <= 1.0:
        raise AssertionError(f"mamba2 small width: loss card {lc} cpu {lp}, "
                             f"worst gradient gap {worst:.3g} of tolerance")
    return lc, lp, worst, len(gp)


@phase("int8 KV cache and Mamba-2 training")
def int8_mamba_phase(smi):
    """ROADMAP D13 and D14b on the card, with B4 at head dim 16: (a)
    ``launch.serve --smoke`` for every published arch; (b) the int8 cache
    at small width, card against CPU; (c) llama3.2-3b at full width and
    depth with the int8 cache, every B3 launch on int8 backing held bit
    for bit, margins too; (d) whisper-large-v3 at full width with it, the
    short set; (e) mamba2-130m trained at published width and depth with
    0 B5 launches, then served (B5 launched), and its small-width
    gradients card against CPU.  Returns (launches, held)."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.retry import RetryPolicy
    from repro_torch.kernels.kv_retry import ops as KV
    from repro_torch.launch import train as TL
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.serving import ServeEngine

    t0 = time.perf_counter()
    launches, held = _serve_smoke_archs()
    print(f"(a) serve --smoke, {len(held['flash_attention'])} B4 launches "
          f"at head dim 16 and {len(held['kv_retry'])} B3 launches held, "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    _print_held("(a) B4 at head dim 16", held["flash_attention"])
    _print_held("(a) B3 on E 16", held["kv_retry"])

    prev = os.environ.get("REPRO_KV_INT8")
    os.environ["REPRO_KV_INT8"] = "1"
    try:
        t0 = time.perf_counter()
        for arch, kw in INT8_SMALL:
            _small_width_check(arch, 1.0, exact=True, **kw)
        print(f"(b) small width, int8 cache: {time.perf_counter() - t0:.3f} s",
              flush=True)

        variants = {**_VARIANTS,
                    "kv_retry_int8": ("int8_launches", "on int8 backing")}
        t0 = time.perf_counter()
        engines, _, got, got_held, out = _serve_full_width(
            SERVE_ARCH, prefix="int8 ", kernels=("kv_retry",),
            variants=variants)
        if not got["kv_retry"]:
            raise AssertionError(f"(c): B3 launches {got}")
        data, scales, bf16 = _int8_cache_bytes(
            engines["pr2ar2"].store.backing)
        rs = got_held["kv_retry"]
        steps = SERVE_MAX_NEW - 1
        bound_ms = _bound(sum(r["t_bytes"] for r in rs),
                          sum(r["t_ops"] for r in rs))[0]
        full_ms = sum(3 * r["leaf"] + 8 * r["pages"] for r in rs) \
            / HBM_BYTES_PER_S * 1e3
        print(f"(c) {SERVE_ARCH} int8 cache on {smi}: the long set's last "
              f"cache {data / 1e6:.3f} MB of int8 k/v + {scales / 1e6:.3f} MB "
              f"of scales against {bf16 / 1e6:.3f} MB in bfloat16; B3 "
              f"{got['kv_retry']} launches, all on int8 backing "
              f"(int8_launches), {len(rs)} held bit for bit: "
              f"{sum(r['ms'] for r in rs) / len(rs):.4f} ms a launch against "
              f"a bytes bound of {bound_ms / len(rs):.4f} (retried backing "
              f"only; {full_ms / len(rs):.4f} reading all backing: 3 P E + "
              f"8 P bytes); B4 {got['flash_attention']} launches "
              f"(tc_launches {got['flash_attention_tc']}); "
              + "; ".join(f"{lab[5:]} prefill {st.prefill_s * 1e3:.1f} ms "
                          f"decode {st.decode_s * 1e3 / steps:.1f} ms a step"
                          for lab, (_, st, _) in out.items())
              + f"; {time.perf_counter() - t0:.3f} s", flush=True)
        _print_held("(c) B3 on int8 backing", rs)
        for k in ("flash_attention", "flash_attention_tc", "kv_retry",
                  "kv_retry_vec", "kv_retry_int8"):
            launches[k] = launches.get(k, 0) + got[k]
        held["kv_retry"] += rs
        del engines, out, got_held
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        cfg = get_config(INT8_ENCDEC)
        n_fa, n_leaves = _encdec_launches(cfg)
        eng = ServeEngine(cfg, policy=RetryPolicy("pr2ar2"), tau=SERVE_TAU,
                          seed=0, device=DEVICE)
        finite = _finite_checked({"pr2ar2": eng})
        short = _request_sets(cfg.vocab)[0][1]
        eng.generate(short, max_new_tokens=2)              # warm-up
        last = (SERVE_MAX_NEW - 2) * n_leaves
        got, got_held, out = _drive(
            [(f"int8 {INT8_ENCDEC} short pr2ar2", eng, short)],
            ("kv_retry",), finite,
            {"kv_retry": lambda i: i < n_leaves or i >= last}, variants)
        want = n_leaves * (SERVE_MAX_NEW - 1)
        if got["kv_retry"] != want or got["kv_retry_int8"] != want or \
                got["flash_attention"] != n_fa:
            raise AssertionError(f"(d): launches {got}")
        data, scales, bf16 = _int8_cache_bytes(eng.store.backing)
        _print_held(f"(d) {INT8_ENCDEC} B3 on int8 backing (first and last "
                    f"decode steps)", got_held["kv_retry"])
        print(f"(d) {INT8_ENCDEC} int8 cache: {data / 1e6:.3f} MB of int8 "
              f"k/v (self and cross) + {scales / 1e6:.3f} MB of scales "
              f"against {bf16 / 1e6:.3f} MB in bfloat16; "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        for k in ("flash_attention", "flash_attention_tc", "kv_retry",
                  "kv_retry_vec", "kv_retry_int8"):
            launches[k] += got[k]
        held["kv_retry"] += got_held["kv_retry"]
        del eng, out, got_held
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        if prev is None:
            os.environ.pop("REPRO_KV_INT8")
        else:
            os.environ["REPRO_KV_INT8"] = prev

    t0 = time.perf_counter()
    cfg = get_config(SSM_ARCH)
    opt = AdamWConfig(moment_dtype=cfg.moment_dtype)
    before = _kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    run = TL.train(cfg, steps=MAMBA_TRAIN_STEPS, batch=TRAIN_BATCH,
                   seq=TRAIN_SEQ, device=DEVICE, opt=opt, log=lambda *_: None)
    losses = [run.losses[i] for i in sorted(run.losses)]
    launched = _launched_since(before)
    n_params = sum(t.numel() for t in tree_leaves(run.state["params"]))
    print(f"(e) train {SSM_ARCH} at published width and depth "
          f"({cfg.n_layers} layers, d {cfg.d_model}), {n_params} parameters, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, {MAMBA_TRAIN_STEPS} AdamW "
          f"steps (lr {opt.lr}) on {smi}: losses {losses}; steps "
          f"{[round(t, 3) for t in run.step_s]} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated; "
          f"launches {launched}", flush=True)
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0] \
            or any(launched.values()):
        raise AssertionError(f"(e) train {SSM_ARCH}: losses {losses}, "
                             f"launches {launched}")
    eng = ServeEngine(cfg, params=run.state["params"],
                      policy=RetryPolicy("pr2ar2"), device=DEVICE)
    before = _kernel_counts()
    _, st = eng.generate(_request_sets(cfg.vocab)[0][1], max_new_tokens=2)
    launched = _launched_since(before)
    if launched["ssd_scan"] != cfg.n_layers or st.kv.pages:
        raise AssertionError(f"(e) serving the trained {SSM_ARCH}: "
                             f"launches {launched}, {st.kv}")
    del run, eng
    gc.collect()
    torch.cuda.empty_cache()
    lc, lp, worst, n = _mamba_grad_check()
    print(f"(e) served the trained weights: B5 {launched['ssd_scan']} "
          f"launches a prefill; small-width {SSM_ARCH} float32 loss card "
          f"{lc!r} cpu {lp!r}, {n} gradient leaves, worst gap "
          f"{worst:.3g} of the tolerance (rtol 1e-5 + 1e-5 of the leaf's "
          f"largest); {time.perf_counter() - t0:.3f} s", flush=True)
    return launches, held


def _compress_tree(device):
    """A seeded gradient tree (Gaussian leaves of several scales, one at
    x.5 of a quantization step) on ``device``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(DIST_COMPRESS_SEED)
    half = rng.integers(-250, 251, 4096).astype(np.float32) / 2
    half[0] = 127.0
    tree = {"w": [rng.standard_normal((1024, 3072)).astype(np.float32)
                  * 10.0 ** -k for k in range(4)], "half": half}
    return {"w": [torch.from_numpy(x).to(device) for x in tree["w"]],
            "half": torch.from_numpy(tree["half"]).to(device)}


def _compress_check():
    """``compress_grads`` over two steps (with error feedback) on the card
    against the CPU, bit for bit."""
    import torch

    from repro_torch.distributed.compress import compress_grads
    from repro_torch.optim.adamw import tree_leaves

    outs = {}
    for dev in (DEVICE, "cpu"):
        tree, ef, got = _compress_tree(dev), None, []
        for _ in range(2):
            out, ef = compress_grads(tree, ef)
            got += [t.cpu() for t in tree_leaves(out) + tree_leaves(ef)]
        outs[dev] = got
    same = all(torch.equal(a, b) and a.dtype == b.dtype
               for a, b in zip(outs[DEVICE], outs["cpu"]))
    n = sum(t.numel() for t in tree_leaves(_compress_tree("cpu")))
    if not same:
        raise AssertionError("compress_grads on the card differs from the "
                             "CPU's")
    return n


def _pad_left(prompts):
    """The serving engine's left-padded (B, T) token batch."""
    import numpy as np

    T = max(len(p) for p in prompts)
    out = np.zeros((len(prompts), T), np.int64)
    for i, p in enumerate(prompts):
        out[i, T - len(p):] = p
    return out


@phase("sharded steps")
def dist_phase(smi, train_losses=None):
    """Phase 19: (a) a one-rank NCCL process group through a FileStore
    under build/, the host mesh on the card and one all-reduce; (b)
    llama3.2-3b's sharded train step (``launch.train.train`` on the
    (1, 1) mesh: ``distributed.steps.make_train_step``, through the
    tensor-parallel pieces at "model" 1) at full width and depth for
    three steps, held against phase 15's losses (``train_losses``; run
    unsharded here when not given), then again under ``launch.cost.trace``
    for its collectives (none moves data on one rank, and the calls are
    the expected ``DIST_STEP_COLLECTIVES`` a step: none from the
    tensor-parallel pieces), and ``compress_grads`` against the CPU bit
    for bit; (c) olmoe-1b-7b at
    full width and depth under ``REPRO_MOE_EP=1``: ``make_prefill_step``
    on the long set through the expert-parallel body (64 local experts),
    every B4 launch held, the logits against the dense dispatch's
    prefill of the same weights, then decode steps whose greedy tokens
    equal the unsharded ``decode_step``'s.  Returns (B4 launches of
    (c)'s prefill and decode, their held records)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import steps as ST
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.plain import bf16_err_ratio
    from repro_torch.launch import cost as C
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as TL
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves, tree_map

    store = ROOT / "build" / "chip_smoke_dist_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    t0 = time.perf_counter()
    rank, world = M.init_process_group(DEVICE, store_path=str(store))
    try:
        mesh = M.make_host_mesh(device=DEVICE)
        probe = torch.full((4,), 3.0, device=DEVICE)
        dist.all_reduce(probe)
        if world != 1 or not bool((probe == 3.0 * world).all()) or \
                dist.get_backend() != M.BACKENDS[mesh.device_type]:
            raise AssertionError(f"process group: rank {rank} of {world}, "
                                 f"{dist.get_backend()}, all-reduce {probe}")
        print(f"(a) {dist.get_backend()} process group of {world} rank "
              f"through a FileStore, mesh {SH.mesh_shape(mesh)} on "
              f"{mesh.device_type}, all-reduce checked, "
              f"{time.perf_counter() - t0:.3f} s", flush=True)

        # (b) the sharded train step at full width and depth.
        before = _kernel_counts()
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        quiet = lambda *_: None      # noqa: E731
        cfg = get_config(TRAIN_ARCH)
        opt = AdamWConfig(lr=TRAIN_LR, moment_dtype=cfg.moment_dtype)
        kw = dict(steps=TRAIN_STEPS, stop_after=DIST_TRAIN_STEPS,
                  batch=TRAIN_BATCH, seq=TRAIN_SEQ, opt=opt, log=quiet)
        if train_losses is None:
            ref = TL.train(cfg, device=DEVICE, **kw)
            train_losses = [ref.losses[i] for i in sorted(ref.losses)]
            del ref
            torch.cuda.empty_cache()
        want = list(train_losses[:DIST_TRAIN_STEPS])
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        run = TL.train(cfg, mesh=mesh, **kw)
        wall = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated() / 1e9
        losses = [run.losses[i] for i in sorted(run.losses)]
        leaves = tree_leaves(run.state["params"])
        if not all(isinstance(x, SH.DTensor) for x in leaves):
            raise AssertionError("the sharded state holds a plain tensor")
        state_gb = sum(SH.local(x).numel() * SH.local(x).element_size()
                       for x in tree_leaves(run.state)) / 1e9
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        if losses == want:
            how = "equal to phase 15's bit for bit"
        elif rel <= DIST_LOSS_RTOL:
            how = (f"within {rel:.3g} relative of phase 15's (not bit for "
                   f"bit)")
        else:
            raise AssertionError(f"sharded losses {losses} != phase 15's "
                                 f"{want}")
        print(f"(b) train {TRAIN_ARCH} full depth on the (1, 1) mesh, batch "
              f"{TRAIN_BATCH} x {TRAIN_SEQ}, {DIST_TRAIN_STEPS} sharded "
              f"steps on {smi}: losses {losses} {how}; grad norms "
              f"{[run.grad_norms[i] for i in sorted(run.grad_norms)]}; "
              f"{wall:.3f} s in all, steps "
              f"{[round(t, 3) for t in run.step_s]} s, {state_gb:.1f} GB "
              f"of DTensor state, peak {peak:.1f} GB allocated", flush=True)
        del run, leaves
        torch.cuda.empty_cache()
        # The same steps again under the cost counter, for its collective
        # count (its dispatch modes move the card's roundings, so these
        # losses are printed, not held).
        tr = C.trace(TL.train, cfg, mesh=mesh, **kw)
        moved = {k: v for k, v in tr.cost.coll_counts.items() if v}
        calls = {k: v for k, v in tr.calls.items()
                 if k.partition(".")[0] in C._COLLECTIVE_NS
                 and k.partition(".")[2] in C.COLLECTIVES}
        want_calls = {k: n * DIST_TRAIN_STEPS
                      for k, n in DIST_STEP_COLLECTIVES.items()}
        if moved or calls != want_calls:
            raise AssertionError(f"the one-rank sharded steps moved data "
                                 f"({moved}) or called collectives {calls} "
                                 f"!= the expected {want_calls}")
        print(f"(b) the same {DIST_TRAIN_STEPS} steps under the cost "
              f"counter ({tr.seconds:.3f} s; losses "
              f"{[tr.out.losses[i] for i in sorted(tr.out.losses)]}): "
              f"collectives {dict(tr.cost.coll_counts)} (0: a one-rank "
              f"group moves nothing); collective calls {calls} = the "
              f"expected (a step: global_norm's all-reduce a "
              f"mesh dim, the heartbeat's all-gather), none from the "
              f"tensor-parallel pieces", flush=True)
        del tr
        torch.cuda.empty_cache()
        torch.use_deterministic_algorithms(False)
        launched = _launched_since(before)
        if any(launched.values()):
            raise AssertionError(f"the sharded train step launched a "
                                 f"kernel: {launched}")
        n = _compress_check()
        print(f"(b) compress_grads on {n} seeded gradient values over two "
              f"steps with error feedback: the card's output and feedback "
              f"equal the CPU's bit for bit", flush=True)
        out = dict(losses=losses, how=how, peak_gb=peak, step_s=wall)

        out["flash_s"] = _flash_prefill_check(mesh, smi)

        # (c) the expert-parallel prefill and decode at full width.
        cfg = get_config(DIST_MOE_ARCH)
        prefill, place = ST.make_prefill_step(cfg, mesh)
        decode, _ = ST.make_decode_step(cfg, mesh)
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(DEVICE).manual_seed(0)     # phase 16's
        params = reshard_state(build_model(cfg, DEVICE, gen).init(), mesh,
                               place)
        torch.cuda.empty_cache()
        init_peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        long = _request_sets(cfg.vocab)[1][1]
        batch = {"tokens": torch.as_tensor(_pad_left(long), device=DEVICE)}
        n_attn = cfg.n_layers
        with torch.no_grad():
            os.environ["REPRO_MOE_EP"] = "0"
            prefill(params, batch)                          # warm-up
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dense, dense_cache = prefill(params, batch)
            torch.cuda.synchronize()
            dense_s = time.perf_counter() - t1
            # The steps' DTensors are whole on one rank.
            dense = dense.to_local()
            dense_cache = tree_map(SH.local, dense_cache)
            os.environ["REPRO_MOE_EP"] = "1"
            prefill(params, batch)          # warm-up: the model group
            FA.launches = FA.tc_launches = 0
            with _Recorder(FA, "flash_attention_fwd") as rec:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                logits, cache = prefill(params, batch)
                torch.cuda.synchronize()
                prefill_s = time.perf_counter() - t1
                logits = logits.to_local()
                toks = [logits[:, -1].argmax(-1)]
                pos = batch["tokens"].shape[1]
                for i in range(DIST_DECODE_STEPS):
                    lg, cache = decode(params, {"token": toks[-1][:, None],
                                                "pos": pos + i,
                                                "cache": cache})
                    toks.append(lg.to_local()[:, -1].argmax(-1))
            launches, tc = FA.launches, FA.tc_launches
            os.environ["REPRO_MOE_EP"] = "0"
            want_toks = [dense[:, -1].argmax(-1)]
            model = build_model(cfg, DEVICE)
            for i in range(DIST_DECODE_STEPS):
                lg, dense_cache = model.decode_step(
                    params, {"token": want_toks[-1][:, None],
                             "pos": pos + i, "cache": dense_cache})
                want_toks.append(lg[:, -1].argmax(-1))
        peak = torch.cuda.max_memory_allocated() / 2**30
        ratio = float(bf16_err_ratio(logits, dense))
        err = float((logits - dense).abs().max())
        if launches != n_attn or tc != launches or rec.n != launches:
            raise AssertionError(f"expert-parallel prefill: {launches} B4 "
                                 f"launches ({tc} on the tensor cores, "
                                 f"{rec.n} recorded), {n_attn} expected")
        if not bool(torch.isfinite(logits).all()) or not ratio <= 1.0:
            raise AssertionError(f"expert-parallel logits against the dense "
                                 f"dispatch's: max abs {err}, worst |err| / "
                                 f"tolerance {ratio}")
        got_t = torch.stack(toks, 1).cpu()
        want_t = torch.stack(want_toks, 1).cpu()
        if not torch.equal(got_t, want_t):
            raise AssertionError(f"expert-parallel greedy tokens {got_t} != "
                                 f"the unsharded decode's {want_t}")
        held = [_hold_fa(f"dist prefill launch {i}", a.pop("q"), a.pop("k"),
                         a.pop("v"), a, got=o, quiet=True)
                for i, (a, o) in enumerate(rec.calls)]
        del rec, cache, dense_cache
        torch.cuda.empty_cache()
        model_calls = _model_group_calls(mesh, prefill, decode, params,
                                         cfg.vocab)
        del params
        torch.cuda.empty_cache()
        print(f"(c) {DIST_MOE_ARCH} full width and depth, REPRO_MOE_EP=1 on "
              f"the (1, 1) mesh ({cfg.moe.n_experts} local experts), long "
              f"set {tuple(batch['tokens'].shape)} on {smi}: prefill "
              f"{prefill_s * 1e3:.1f} ms (the dense dispatch's "
              f"{dense_s * 1e3:.1f}), logits against the dense "
              f"dispatch's max abs {err:.3g} (worst |err| / tolerance "
              f"{ratio:.3g}), {DIST_DECODE_STEPS} decode steps' greedy "
              f"tokens equal the unsharded decode's, peak {peak:.2f} GiB "
              f"(placing the parameters {init_peak:.2f}); "
              f"B4 {launches} launches (tc_launches {tc}); collectives on "
              f"the \"model\" group, a prefill and a decode step of each "
              f"dispatch under the cost counter: {model_calls}", flush=True)
        _print_held("  dist prefill flash_attention", held)
        out.update(prefill_ms=prefill_s * 1e3, dense_ms=dense_s * 1e3,
                   logits_ratio=ratio)
        out["ssd_launches"], out["ssd_held"] = _dist_mamba(mesh, smi)
        return launches, held, out
    finally:
        os.environ.pop("REPRO_MOE_EP", None)
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def _flash_prefill_check(mesh, smi):
    """Phase 19 (b'): llama3.2-3b's ``make_prefill_step`` at full width and
    depth on the one-rank mesh, on the short set, in the base mode and
    under ``REPRO_ATTN_IMPL=flash`` (the reference's flash mode: at
    "model" 1 the sequence pieces are the identity, ROADMAP D15c-2b): the
    two steps' logits equal bit for bit.  Returns its seconds."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import steps as ST
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    prefill, place = ST.make_prefill_step(cfg, mesh)
    gen = torch.Generator(DEVICE).manual_seed(0)
    params = reshard_state(build_model(cfg, DEVICE, gen).init(), mesh, place)
    toks = torch.as_tensor(_pad_left(_request_sets(cfg.vocab)[0][1]),
                           device=DEVICE)
    out = {}
    try:
        with torch.no_grad():
            for mode in ("blockwise", "flash"):
                os.environ["REPRO_ATTN_IMPL"] = mode
                out[mode] = prefill(params, {"tokens": toks})[0].to_local()
    finally:
        os.environ.pop("REPRO_ATTN_IMPL", None)
    if not bool(torch.isfinite(out["flash"]).all()) or \
            not torch.equal(out["flash"], out["blockwise"]):
        raise AssertionError(f"{TRAIN_ARCH} prefill under "
                             f"REPRO_ATTN_IMPL=flash differs from the base "
                             f"step's (max abs "
                             f"{float((out['flash'] - out['blockwise']).abs().max())})")
    del params, out
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"(b') {TRAIN_ARCH} full width and depth, make_prefill_step on "
          f"the short set {tuple(toks.shape)} on {smi}: logits under "
          f"REPRO_ATTN_IMPL=flash equal the base step's bit for bit; "
          f"{secs:.1f} s", flush=True)
    return secs


def _dist_mamba(mesh, smi):
    """Phase 19 (d): mamba2-130m at full width and depth on the one-rank
    mesh: ``make_prefill_step`` on the short set (B5 through the sharded
    step: a launch a layer, each held against the plain version), then
    ``DIST_SSM_DECODE_STEPS`` ``make_decode_step`` steps, their greedy
    tokens against the unsharded ``prefill`` and ``decode_step``'s bit
    for bit, and a prefill and a decode step's collectives on the
    "model" group under the cost counter (0).  Returns (B5 launches,
    held records)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import steps as ST
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.distributed.sharding import local
    from repro_torch.kernels.ssd_scan import ops as SO
    from repro_torch.launch import cost as C
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    cfg = get_config(SSM_ARCH)
    prefill, place = ST.make_prefill_step(cfg, mesh)
    decode, _ = ST.make_decode_step(cfg, mesh)
    model = build_model(cfg, DEVICE, torch.Generator(DEVICE).manual_seed(0))
    plain = model.init()
    params = reshard_state(plain, mesh, place)
    toks = torch.as_tensor(_pad_left(_request_sets(cfg.vocab)[0][1]),
                           device=DEVICE)
    pos = toks.shape[1]

    def greedy(first, step, cache):
        out = [first[:, -1].argmax(-1)]
        for i in range(DIST_SSM_DECODE_STEPS):
            lg, cache = step({"token": out[-1][:, None], "pos": pos + i,
                              "cache": cache})
            out.append(local(lg)[:, -1].argmax(-1))
        return torch.stack(out, 1).cpu()

    with torch.no_grad():
        SO.launches = 0
        with _Recorder(SO, "ssd_scan_fwd") as rec:
            logits, cache = prefill(params, {"tokens": toks})
        launches = SO.launches
        got = greedy(local(logits), lambda b: decode(params, b), cache)
        lg, cache = model.prefill(plain, {"tokens": toks})
        want = greedy(lg, lambda b: model.decode_step(plain, b), cache)
    if launches != cfg.n_layers or rec.n != launches:
        raise AssertionError(f"{SSM_ARCH} sharded prefill: {launches} B5 "
                             f"launches ({rec.n} recorded), {cfg.n_layers} "
                             f"expected")
    if not torch.equal(got, want):
        raise AssertionError(f"{SSM_ARCH} sharded greedy tokens {got} != "
                             f"the unsharded decode's {want}")
    held = [_HOLDERS["ssd_scan"][1](f"dist mamba prefill launch {i}", a, o)
            for i, (a, o) in enumerate(rec.calls)]
    del rec, cache
    torch.cuda.empty_cache()

    def steps():
        lg, c = prefill(params, {"tokens": toks})
        tok = local(lg)[:, -1].argmax(-1)[:, None]
        decode(params, {"token": tok, "pos": pos, "cache": c})

    with torch.no_grad():
        calls = C.trace(steps).group_calls.get(
            mesh.get_group("model").group_name, 0)
    if calls:
        raise AssertionError(f"the one-rank {SSM_ARCH} serve steps issued "
                             f"{calls} collectives on the \"model\" group")
    print(f"(d) {SSM_ARCH} full width and depth on the (1, 1) mesh, short "
          f"set {tuple(toks.shape)} on {smi}: B5 {launches} launches "
          f"through make_prefill_step, each held against the plain "
          f"version; {DIST_SSM_DECODE_STEPS} make_decode_step step(s)' "
          f"greedy tokens equal the unsharded prefill and decode_step's "
          f"bit for bit; collectives on the \"model\" group, a prefill and a "
          f"decode step under the cost counter: {calls}; "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    _print_held("  dist mamba prefill ssd_scan", held)
    return launches, held


def _model_group_calls(mesh, prefill, decode, params, vocab):
    """The collectives a prefill of the short set and one decode step of
    phase 19 (c) issue on the one-rank mesh's "model" group, under the
    dense dispatch and the expert-parallel body (``launch.cost.trace``'s
    ``group_calls``): {dispatch: calls}, which must be 0."""
    import torch

    from repro_torch.launch import cost as C

    toks = torch.as_tensor(_pad_left(_request_sets(vocab)[0][1]),
                           device=DEVICE)

    def steps():
        logits, cache = prefill(params, {"tokens": toks})
        tok = logits.to_local()[:, -1].argmax(-1)[:, None]
        decode(params, {"token": tok, "pos": toks.shape[1], "cache": cache})

    name = mesh.get_group("model").group_name
    out = {}
    with torch.no_grad():
        for ep, dispatch in (("0", "dense"), ("1", "expert-parallel")):
            os.environ["REPRO_MOE_EP"] = ep
            out[dispatch] = C.trace(steps).group_calls.get(name, 0)
    os.environ["REPRO_MOE_EP"] = "0"
    if any(out.values()):
        raise AssertionError(f"the one-rank serve steps issued collectives "
                             f"on the \"model\" group: {out}")
    return out


def _fake_launch_checks():
    """Phase 20 (a): each noted launch's inputs as fake CUDA tensors
    through the custom op; its fake outputs' shapes, dtypes and strides
    must be the real launch's.  Returns the count of shapes held per
    kernel."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.ssd_scan import ops as SSD

    ops = {"flash_attention": torch.ops.repro_torch.flash_attention,
           "ssd_scan": torch.ops.repro_torch.ssd_scan}
    if not all(LAUNCHED.values()):            # the phase run alone
        gen = torch.Generator(DEVICE).manual_seed(20)
    if not LAUNCHED["flash_attention"]:
        B, T, H, K, hd = PREFILL_SHAPE
        q, k, v = (torch.randn((B, T, n, hd), generator=gen, device=DEVICE,
                               dtype=torch.bfloat16) for n in (H, K, K))
        FA.flash_attention(q.view(B, T, K, H // K, hd), k, v)
    if not LAUNCHED["ssd_scan"]:
        B, T, nh, hd, ds, chunk = SSD_SHAPE
        SSD.ssd_scan_fwd(*_ssd_inputs(gen, B, nh, T, hd, ds, torch.bfloat16),
                         chunk=chunk)
    held = {}
    with FakeTensorMode():
        for kernel, seen in LAUNCHED.items():
            for (ins, static), want in seen.items():
                st = dict(static)
                ts = [torch.empty_strided(shape, stride,
                                          dtype=getattr(torch, dt[6:]),
                                          device="cuda")
                      for shape, dt, stride in ins]
                if kernel == "flash_attention":
                    cap, kv = st["softcap"], st["kv_valid"]
                    out = ops[kernel](
                        *ts, bool(st["causal"]), st["window"],
                        None if cap is None else float(cap),
                        None if kv is None else int(kv),
                        int(st.get("q_offset", 0)))
                else:
                    out = ops[kernel](*ts, st["chunk"])
                outs = tuple(out) if isinstance(out, (tuple, list)) else \
                    (out,)
                got = tuple(_meta_of(t) for t in outs)
                if got != want:
                    raise AssertionError(f"{kernel} fake outputs {got} != "
                                         f"the launch's {want} at {ins} "
                                         f"{st}")
            held[kernel] = len(seen)
    return held


def _real_params(gen):
    """The real cells' llama3.2-3b parameters, bf16, drawn from ``gen``
    on the card (made once for phase 20's prefill and decode cells)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import tree_map

    params = build_model(get_config(DRYRUN_REAL[0]), DEVICE, gen).init()
    return tree_map(lambda p: p.to(torch.bfloat16), params)


def _real_prefill_cell(smi, params, gen):
    """Phase 20 (c): llama3.2-3b's prefill at B 1 x T 2048 from
    ``build_cell``, first traced by the dry-run over a fake one-rank
    group, then run for real on a one-rank NCCL mesh under the same
    counters, with ``params`` (:func:`_real_params`) and tokens drawn
    from ``gen``."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import steps as ST
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.launch import cost as C
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as M

    arch, B, T = DRYRUN_REAL
    cfg = get_config(arch)
    shape = ShapeConfig(f"prefill_{T}", T, B, "prefill")
    rec = DR.run_cell(arch, shape.name, "1x1", ROOT / "build" / "dryrun",
                      cfg=cfg, shape=shape)
    store = ROOT / "build" / "chip_smoke_dryrun_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    M.init_process_group(DEVICE, store_path=str(store))
    try:
        mesh = M.make_mesh((1, 1), device=DEVICE)
        step, specs, places = ST.build_cell(cfg, shape, mesh)
        params = reshard_state(params, mesh, places[0])
        toks = torch.randint(0, cfg.vocab, (B, T), generator=gen,
                             device=DEVICE, dtype=torch.int32)
        batch = {"tokens": toks}
        held = DR.held_bytes((params, batch))
        step(params, batch)                                   # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        n0 = FA.launches
        tr = C.trace(step, params, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        launches = FA.launches - n0
        calls = tr.calls.get("repro_torch.flash_attention", 0)
        logits = tr.out[0].to_local()
        finite = bool(torch.isfinite(logits.float()).all())
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    mem = rec["memory"]
    if tr.cost.flops != rec["flops_per_device"]:
        raise AssertionError(f"real {arch} prefill counts {tr.cost.flops} "
                             f"FLOPs, its dry-run {rec['flops_per_device']}")
    if calls != launches or launches != cfg.n_layers:
        raise AssertionError(f"B4 op calls {calls}, launches {launches}, "
                             f"{cfg.n_layers} layers")
    if held != mem["argument_bytes"]:
        raise AssertionError(f"real inputs hold {held} bytes, the dry-run's "
                             f"argument_bytes {mem['argument_bytes']}")
    if not finite or tuple(logits.shape) != (B, 1, cfg.vocab):
        raise AssertionError(f"real prefill logits {tuple(logits.shape)}, "
                             f"finite {finite}")
    print(f"(c) {arch} prefill B {B} x T {T} from build_cell on one NCCL "
          f"rank on {smi}: FlopCounterMode {tr.cost.flops:.6e} FLOPs "
          f"({tr.breakdown()}) equal to the dry-run's; B4 op calls {calls} "
          f"= launches {launches}; inputs {held} bytes = the dry-run's "
          f"argument_bytes; dry-run temp_bytes {mem['temp_bytes']} "
          f"({mem['temp_bytes'] / 2**30:.3f} GiB; the same counter on "
          f"the real run {tr.peak_bytes}) beside the step's "
          f"max_memory_allocated above its inputs {peak} "
          f"({peak / 2**30:.3f} GiB); logits finite; real step "
          f"{tr.seconds * 1e3:.1f} ms under the counters, dry-run trace "
          f"{rec['trace_s']} s", flush=True)
    return dict(flops=tr.cost.flops, temp_bytes=mem["temp_bytes"],
                peak=peak, launches=launches)


def _real_decode_cells(smi, params, gen):
    """Phase 20 (c'): llama3.2-3b's decode step at B 1 over a 2 048-slot
    cache, bf16 and int8, from ``build_cell`` on a one-rank NCCL mesh,
    counted by ``FlopCounterMode`` and held against the ``dot + kernel``
    of the same cell's dry-run under ``flash`` (``flash+kvint8``): the
    decode stand-in's 401/402 formula is the two products the card
    runs.  ``params`` from :func:`_real_params`; the token and the cache
    drawn from ``gen``."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import steps as ST
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.launch import cost as C
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as M
    from repro_torch.optim.adamw import tree_map

    arch, B, S = DRYRUN_REAL
    cfg = get_config(arch)
    shape = ShapeConfig(f"decode_{S}", S, B, "decode")
    recs = {v: DR.run_cell(arch, shape.name, "1x1",
                           ROOT / "build" / "dryrun", v, cfg=cfg,
                           shape=shape)
            for v in ("flash", "flash+kvint8")}
    store = ROOT / "build" / "chip_smoke_dryrun_store"
    store.unlink(missing_ok=True)
    M.init_process_group(DEVICE, store_path=str(store))
    out = {}
    try:
        mesh = M.make_mesh((1, 1), device=DEVICE)
        for variant, rec in recs.items():
            int8 = "kvint8" in variant
            # The real step: the cache's switch without the stand-ins.
            with DR.variant_switches({"kvint8"} if int8 else set()):
                step, specs, places = ST.build_cell(cfg, shape, mesh)
            placed = reshard_state(params, mesh, places[0])

            def leaf(t):
                if t.dtype == torch.int8:
                    return torch.randint(-127, 128, t.shape, generator=gen,
                                         device=DEVICE, dtype=torch.int8)
                x = torch.rand(t.shape, generator=gen, device=DEVICE)
                return (x * 0.02 if t.dtype == torch.float32
                        else x - 0.5).to(t.dtype)

            batch = {"token": torch.randint(0, cfg.vocab, (B, 1),
                                            generator=gen, device=DEVICE,
                                            dtype=torch.int32),
                     "pos": S, "cache": tree_map(leaf, specs[1]["cache"])}
            tr = C.trace(step, placed, batch)
            logits = tr.out[0].to_local()
            split = rec["flops_breakdown"]
            want = split["dot"] + split["kernel"]
            calls = rec["kernel_calls"]["decode_attention_standin"]
            if tr.cost.flops != want:
                raise AssertionError(f"real {arch} decode ({variant}) counts "
                                     f"{tr.cost.flops} FLOPs, its dry-run "
                                     f"dot + kernel {want} ({split})")
            if calls != cfg.n_layers or split["kernel"] <= 0:
                raise AssertionError(f"{variant} dry-run: {calls} decode "
                                     f"stand-in calls, {split}")
            if tuple(logits.shape) != (B, 1, cfg.vocab) or not bool(
                    torch.isfinite(logits.float()).all()):
                raise AssertionError(f"real decode logits "
                                     f"{tuple(logits.shape)} not finite")
            cache = "int8" if int8 else "bf16"
            print(f"(c') {arch} decode B {B} over {S} {cache} slots from "
                  f"build_cell on one NCCL rank on {smi}: "
                  f"FlopCounterMode {tr.cost.flops:.6e} FLOPs "
                  f"({tr.breakdown()}) = the {variant} dry-run's dot + "
                  f"kernel {want:.6e} ({split}, {calls} decode stand-in "
                  f"calls); logits finite", flush=True)
            out[variant] = tr.cost.flops
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    return out


def _standins_raise():
    """Phase 20 (d): every stand-in op called on real CUDA tensors
    raises: none has a device implementation."""
    import torch

    from repro_torch.kernels import opaque

    ops = torch.ops.repro_torch
    kw = dict(device=DEVICE, dtype=torch.bfloat16)
    q = torch.zeros(1, 8, 2, 2, 64, **kw)
    k = torch.zeros(1, 8, 2, 64, **kw)
    ck = torch.zeros(1, 2, 8, 64, device=DEVICE, dtype=torch.int8)
    sc = torch.ones(1, 2, 8, 1, device=DEVICE)
    x = torch.zeros(1, 8, 2, 64, **kw)
    bm = torch.zeros(1, 8, 16, **kw)
    dt = torch.zeros(1, 8, 2, device=DEVICE)
    a = torch.zeros(2, device=DEVICE)
    calls = {
        "flash_attention_fwd_standin":
            lambda: ops.flash_attention_fwd_standin(q, k, k, True, None),
        "flash_attention_bwd_standin":
            lambda: ops.flash_attention_bwd_standin(q, k, k, q, True, None),
        "decode_attention_standin":
            lambda: ops.decode_attention_standin(q[:, :1], ck, ck, sc, sc, 4),
        "ssd_scan_fwd_standin":
            lambda: ops.ssd_scan_fwd_standin(x, bm, bm, dt, a, 8),
        "ssd_scan_bwd_standin":
            lambda: ops.ssd_scan_bwd_standin(x, bm, bm, dt, a, x, 8),
    }
    assert set(calls) == set(opaque.OPS)
    for name, call in calls.items():
        try:
            call()
        except NotImplementedError:
            continue
        raise AssertionError(f"stand-in {name} ran on CUDA tensors")
    print(f"(d) the {len(calls)} stand-ins raise NotImplementedError on CUDA "
          f"tensors", flush=True)
    return len(calls)


def _standin_formula(arch, shape_name, variant):
    """The stand-in FLOPs one rank of the 16 x 16 mesh should count for a
    (b) cell, from the reference's marker formulas summed over the
    config's layers: under the unit's remat two forwards and a backward
    a layer (flash x 2.5, the scan x 3) over the rank's ``seq_len`` / 16
    queries of the context-parallel flash mode (ROADMAP D15c-2b), decode
    one fused call a layer over this rank's share of the cache, as the
    reference's ``shard_map`` divides it over "model" 16: its kv heads
    where 16 divides them, else its ``seq_len`` / 16 slots where 16
    divides those."""
    from repro_torch.configs import SHAPES, get_config

    cfg, shape = get_config(arch), SHAPES[shape_name]
    B = shape.global_batch // 16
    T = shape.seq_len
    if variant == "ssdk":
        s = cfg.ssm
        nh, hd, ds, L = s.n_heads(cfg.d_model), s.head_dim, s.d_state, \
            s.chunk
        fwd = B * nh * T * (2 * L * (ds + hd) + 4 * ds * hd)
        return cfg.n_layers * (2 * fwd + 3 * fwd)
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    G = cfg.n_heads // K
    if shape.kind == "decode":
        share = 16 if K % 16 == 0 or T % 16 == 0 else 1
        return cfg.n_layers * 4 * B * K * G * hd * T // share
    fwd = 4 * B * (T // 16) * K * G * hd * T // 2     # causal (101)
    return cfg.n_layers * (2 * fwd + fwd * 5 // 2)


def start_dryrun_cells():
    """Start phase 20 (b): every cell of ``DRYRUN_CELLS`` traced over a
    fake 16 x 16 group, one process each, all at once (a thread for each
    variant's group), in the background; they use the host's cores and
    no device.  ``main()`` starts them before phase 18."""
    import threading

    from repro_torch.launch import dryrun as DR

    if _DRYRUN:
        return
    out_dir = ROOT / "build" / "dryrun"
    by_variant, done = {}, []
    for arch, shape, variant in DRYRUN_CELLS:
        by_variant.setdefault(variant, []).append((arch, shape, "single"))

    def cells(variant, cs):
        done.extend((c, variant, st) for c, st in DR.run_cells(
            cs, out_dir, variant, jobs=len(cs),
            timeout=DRYRUN_CELL_TIMEOUT_S))

    threads = [threading.Thread(target=cells, args=item)
               for item in by_variant.items()]
    for t in threads:
        t.start()
    _DRYRUN.update(threads=threads, done=done, out_dir=out_dir,
                   t0=time.perf_counter())


@phase("dryrun")
def dryrun_phase(smi):
    """Phase 20: (c) one real prefill cell and (c') two real decode cells
    against their dry-runs, (d) the stand-ins raising on CUDA tensors, (a)
    the custom ops' fake outputs against every distinct B4 and B5 launch
    of the run, then (b)'s full-width cells (started by
    :func:`start_dryrun_cells`, here if not before) are joined and
    printed; each part's seconds are printed."""
    import torch

    from repro_torch.launch import dryrun as DR

    t0 = time.perf_counter()
    props = torch.cuda.get_device_properties(0)
    print(f"card total_memory {props.total_memory} bytes on {smi} (the "
          f"dry-run holds each rank's total against "
          f"{DR.CARD_MEMORY_BYTES})", flush=True)
    if props.total_memory != DR.CARD_MEMORY_BYTES:
        print(f"NOTE: launch.dryrun.CARD_MEMORY_BYTES "
              f"({DR.CARD_MEMORY_BYTES}) is not this card's "
              f"{props.total_memory}", flush=True)
    start_dryrun_cells()
    t = time.perf_counter()
    gen = torch.Generator(DEVICE).manual_seed(20)
    params = _real_params(gen)
    parts = {"params": time.perf_counter() - t}
    t = time.perf_counter()
    real = _real_prefill_cell(smi, params, gen)
    parts["c"], t = time.perf_counter() - t, time.perf_counter()
    real["decode"] = _real_decode_cells(smi, params, gen)
    del params
    parts["c'"], t = time.perf_counter() - t, time.perf_counter()
    real["standins_raise"] = _standins_raise()
    parts["d"], t = time.perf_counter() - t, time.perf_counter()
    held = _fake_launch_checks()
    parts["a"] = time.perf_counter() - t
    print(f"(a) fake outputs equal to the launches' (shapes, dtypes, "
          f"strides): {held} distinct launch shapes", flush=True)
    for w in _DRYRUN["threads"]:
        w.join()
    done, out_dir = _DRYRUN["done"], _DRYRUN["out_dir"]
    print(f"(b) the cells' processes ended "
          f"{time.perf_counter() - _DRYRUN['t0']:.1f} s after they started "
          f"({t0 - _DRYRUN['t0']:.1f} s before this phase)", flush=True)
    bad = [(c, v, st) for c, v, st in done if st != "ok"]
    if bad or len(done) != len(DRYRUN_CELLS):
        raise AssertionError(f"dry-run cells failed: {bad}")
    recs = {}
    for (arch, shape, mesh), variant, _ in done:
        rec = recs[arch, shape, variant] = json.loads(DR._record_path(
            out_dir, arch, shape, mesh, variant).read_text())
        m, c = rec["memory"], rec["collectives"]
        print(f"(b) {arch} x {shape} x {mesh} [{variant}] trace_s "
              f"{rec['trace_s']}: FLOPs/rank {rec['flops_per_device']:.4e} "
              f"{rec['flops_breakdown']}, bytes "
              f"{rec['bytes_accessed_per_device']:.4e}; memory argument "
              f"{m['argument_bytes']} output {m['output_bytes']} temp "
              f"{m['temp_bytes']} step argument {m['step_argument_bytes']} "
              f"fits {m['fits']}; collectives counts {c['counts']} traffic "
              f"{ {k: round(v) for k, v in c['traffic'].items()} }; kernel "
              f"calls {rec['kernel_calls']}", flush=True)
    for key, (dot, kernel) in DRYRUN_WHOLE_SSM.items():
        b = recs[key]["flops_breakdown"]
        print(f"(b) {' x '.join(key)}: dot {b['dot']:.6e} kernel "
              f"{b['kernel']:.6e} a rank, with Mamba-2's products divided "
              f"over \"model\" where it divides them (whole over \"model\": "
              f"dot {dot:.6e} kernel {kernel:.6e})", flush=True)
    for (arch, shape, variant), rec in recs.items():
        if variant not in ("flash", "ssdk", "flash+kvint8"):
            continue
        kernel = rec["flops_breakdown"]["kernel"]
        want = _standin_formula(arch, shape, variant)
        base = recs.get((arch, shape, "base"))
        print(f"(b) {arch} x {shape} [{variant}]: kernel FLOPs {kernel:.6e} "
              f"= the marker formula summed over the layers {want:.6e}; dot "
              f"{rec['flops_breakdown']['dot']:.6e}"
              + ("" if base is None else
                 f" (base {base['flops_breakdown']['dot']:.6e})"),
              flush=True)
        if kernel != want:
            raise AssertionError(f"{arch} {shape} {variant}: kernel FLOPs "
                                 f"{kernel}, the marker formula {want}")
        if base is not None and not (rec["flops_breakdown"]["dot"] <
                                     base["flops_breakdown"]["dot"]):
            raise AssertionError(f"{arch} {shape} {variant}: dot not below "
                                 f"base's")
    for (arch, shape, variant), rec in recs.items():
        m = rec["memory"]
        if "train" not in shape and (m["step_argument_bytes"]
                                     != m["argument_bytes"]):
            raise AssertionError(f"{arch} {shape} {variant}: the step "
                                 f"holds {m['step_argument_bytes']} bytes "
                                 f"of arguments, its placements "
                                 f"{m['argument_bytes']}")
    phase_s = time.perf_counter() - t0
    print(f"dryrun phase {phase_s:.1f} s (budget {DRYRUN_BUDGET_S:.0f} s): "
          + ", ".join(f"({k}) {v:.1f} s" for k, v in parts.items()),
          flush=True)
    return dict(real, held=held, seconds=phase_s)


def _print_held(name, rs):
    """One line for the launches of one run, held and re-timed."""
    bound_ms, bound_by = _bound(sum(r["t_bytes"] for r in rs),
                                sum(r["t_ops"] for r in rs))
    lib = [r.get("library_ms") for r in rs]
    if "pages" in rs[0]:
        extra = (f", {sum(r['retried'] for r in rs)} of "
                 f"{sum(r['pages'] for r in rs)} pages retried, "
                 f"{sum(r['flips'] for r in rs)} decisions the plain "
                 f"version's sum order rounds the other way, "
                 f"{sum(r['moved'] for r in rs) / 1e9:.3f} GB moved (int8 "
                 f"pages, scales, margins, output, retried backing) for "
                 f"{sum(r['leaf'] for r in rs) / 1e9:.3f} GB of backing "
                 f"leaves")
    else:
        extra = (f", worst |err| / tolerance "
                 f"{max(r['tol_ratio'] for r in rs):.3g}")
        if "h_ratio" in rs[0]:
            extra += f" (H {max(r['h_ratio'] for r in rs):.3g})"
    print(f"{name}: {len(rs)} launches held{extra}, max_abs_err "
          f"{max(r['max_abs_err'] for r in rs):.3g}; kernel "
          f"{sum(r['ms'] for r in rs):.3f} ms (largest launch "
          f"{max(r['ms'] for r in rs):.3f}), plain "
          f"{sum(r['plain_ms'] for r in rs):.3f} ms, library "
          f"{'none' if None in lib else f'{sum(lib):.3f} ms'}, bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)


def _kernel_line(name, source, replaces, launches, cases, held, library):
    """One kernel's entry of the JSON line: times, bound and library time
    summed over the main path's launches, each re-run on its inputs."""
    bound_ms, bound_by = _bound(sum(r["t_bytes"] for r in held),
                                sum(r["t_ops"] for r in held))
    lib = [r.get("library_ms") for r in held]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in cases + held),
        "ms": sum(r["ms"] for r in held),
        "plain_ms": sum(r["plain_ms"] for r in held),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": sum(lib) if library and None not in lib else None,
    }


def _sub_sums(prefix, held):
    """Kernel, plain and bound milliseconds summed over a subset of a
    kernel's held launches, for its row of the JSON line."""
    return {f"{prefix}_ms": sum(r["ms"] for r in held),
            f"{prefix}_plain_ms": sum(r["plain_ms"] for r in held),
            f"{prefix}_bound_ms": _bound(sum(r["t_bytes"] for r in held),
                                         sum(r["t_ops"] for r in held))[0]}


def setup() -> None:
    """The process state every phase expects: the checkout's sources on
    the path, checkout-local characterization caches (fresh for each
    device, so the card does its own work and nothing outside the
    checkout is read or written), and float32 products without TF32.
    A script that runs single phases calls it, then ``device_phase()`` and
    ``build_phase()``."""
    import torch

    sys.path.insert(0, str(SRC))
    os.environ["REPRO_TORCH_CHAR_CACHE_DIR"] = str(CACHE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _note_launches()


def _meta_of(t):
    return (tuple(t.shape), str(t.dtype), tuple(t.stride()))


def _note_launches():
    """Wrap the B4 and B5 wrappers (``functools.wraps`` keeps their
    signatures for ``_Recorder``) so that each distinct CUDA launch is
    noted in ``LAUNCHED`` with its output's metadata, for phase 20 (a)."""
    import functools
    import inspect

    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.ssd_scan import ops as SSD

    for mod, name, kernel in ((FA, "flash_attention_fwd", "flash_attention"),
                              (SSD, "ssd_scan_fwd", "ssd_scan")):
        orig = getattr(mod, name)
        if getattr(orig, "_notes_launches", False):
            continue
        sig = inspect.signature(orig)

        def noted(*a, _orig=orig, _sig=sig, _kernel=kernel, **kw):
            out = _orig(*a, **kw)
            bound = _sig.bind(*a, **kw)
            bound.apply_defaults()
            args = dict(bound.arguments)
            tensors = [v for v in args.values() if hasattr(v, "stride")]
            if tensors and tensors[0].device.type == "cuda":
                key = (tuple(_meta_of(t) for t in tensors),
                       tuple((k, v) for k, v in args.items()
                             if not hasattr(v, "stride")))
                outs = out if isinstance(out, tuple) else (out,)
                LAUNCHED[_kernel].setdefault(
                    key, tuple(_meta_of(t) for t in outs))
            return out

        noted = functools.wraps(orig)(noted)
        noted._notes_launches = True
        setattr(mod, name, noted)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    setup()
    name, smi = device_phase()
    build_phase()
    characterize_phase()
    kern, chain_ns = kernel_phase()
    launches, smem_launches, held = main_path_phase(chain_ns)
    wide_launches, wide_smem_launches, wide_held = wide_phase(chain_ns)
    torch.cuda.empty_cache()
    fa_cases, kv_cases, _, cp_held = serve_kernel_phase()
    serve_launches, held_fa, held_kv, _ = serve_path_phase()
    torch.cuda.empty_cache()
    ssd_cases, _, rber_launches, rber = ssd_rber_kernel_phase()
    ssd_launches, held_ssd = mamba_serve_phase()
    torch.cuda.empty_cache()
    sweep_launches, sweep_held = sweep_phase(smi)
    torch.cuda.empty_cache()
    gc_launches, gc_smem_launches, gc_held, gc_res, gc_inplace = gc_phase(
        smi, chain_ns)
    closed_launches, closed_held = closed_loop_phase(smi)
    online_fault_launches = online_faults_phase(smi, gc_res, gc_inplace)
    torch.cuda.empty_cache()
    calibrate_phase(smi)
    train = train_phase(smi)
    torch.cuda.empty_cache()
    family_launches, family_held, _ = family_phase(smi)
    for k, n in family_launches.items():
        serve_launches[k] += n
    held_fa += family_held["flash_attention"]
    held_kv += family_held["kv_retry"]
    torch.cuda.empty_cache()
    encdec_launches, encdec_held, _ = encdec_phase(smi)
    for k, n in encdec_launches.items():
        serve_launches[k] += n
    held_fa += encdec_held["flash_attention"]
    held_kv += encdec_held["kv_retry"]
    torch.cuda.empty_cache()
    start_dryrun_cells()
    int8_launches, int8_held = int8_mamba_phase(smi)
    for k in ("flash_attention", "flash_attention_tc", "kv_retry",
              "kv_retry_vec"):
        serve_launches[k] += int8_launches[k]
    held_kv += int8_held["kv_retry"]
    torch.cuda.empty_cache()
    dist_launches, dist_held, dist_out = dist_phase(smi, train["losses"])
    torch.cuda.empty_cache()
    dryrun_phase(smi)
    # The head-dim-16 launches are summed apart: SDPA has no softcap, so
    # with gemma2's among them the row's library time would be null.
    held_small = int8_held["flash_attention"]
    held_int8 = [r for r in int8_held["kv_retry"] if r["int8"]]
    small_hd = int8_launches["flash_attention_small_hd"]
    if serve_launches["flash_attention_tc"] + small_hd != \
            serve_launches["flash_attention"]:
        raise AssertionError(f"flash_attention launches {serve_launches}, "
                             f"{small_hd} at head dim 16")

    # Times and bounds are sums over each main path's launches, each
    # re-run on the inputs it had there.
    kernels = "src/repro_torch/kernels"
    print(json.dumps({"kernels": [
        dict(_kernel_line(
            "fcfs_core", f"{kernels}/fcfs_core/csrc/fcfs_core.cu",
            "src/repro/kernels/fcfs_core/kernel.py:120", launches, kern,
            held, library=False), smem_launches=smem_launches,
            wide_dies_cases=[r["case"] for r in kern
                             if r["n_dies"] > 16],
            wide_launches=wide_launches,
            wide_smem_launches=wide_smem_launches,
            wide_held=len(wide_held),
            wide_plain_steps=min(r["plain_steps"] for r in wide_held),
            **_sub_sums("wide", wide_held),
            sweep_launches=sweep_launches, sweep_ms=sweep_held["ms"],
            sweep_plain_ms=sweep_held["plain_ms"],
            sweep_bound_ms=sweep_held["bound_ms"],
            gc_launches=gc_launches, gc_smem_launches=gc_smem_launches,
            gc_ms=gc_held["ms"], gc_plain_ms=gc_held["plain_ms"],
            gc_plain_steps=gc_held["plain_steps"],
            gc_bound_ms=gc_held["bound_ms"],
            closed_launches=closed_launches,
            closed_ms=sum(r["ms"] for r in closed_held),
            closed_plain_ms=sum(r["plain_ms"] for r in closed_held),
            closed_bound_ms=_bound(
                sum(r["t_bytes"] for r in closed_held),
                sum(r["t_ops"] for r in closed_held))[0],
            online_fault_launches=online_fault_launches),
        dict(_kernel_line("flash_attention",
                          f"{kernels}/flash_attention/csrc/flash_attention.cu",
                          "src/repro/kernels/flash_attention/kernel.py:34",
                          serve_launches["flash_attention"],
                          fa_cases + held_small, held_fa, library=True),
             tc_launches=serve_launches["flash_attention_tc"],
             family_launches=family_launches["flash_attention"],
             encdec_launches=encdec_launches["flash_attention"],
             small_hd_launches=small_hd,
             **_sub_sums("small_hd", held_small),
             dist_launches=dist_launches, **_sub_sums("dist", dist_held),
             cp_launches=len(cp_held), **_sub_sums("cp", cp_held)),
        dict(_kernel_line("kv_retry", f"{kernels}/kv_retry/csrc/kv_retry.cu",
                          "src/repro/kernels/kv_retry/kernel.py:26",
                          serve_launches["kv_retry"], kv_cases, held_kv,
                          library=False),
             vec_launches=serve_launches["kv_retry_vec"],
             family_launches=family_launches["kv_retry"],
             encdec_launches=encdec_launches["kv_retry"],
             encdec_held=len(encdec_held["kv_retry"]),
             int8_launches=int8_launches["kv_retry_int8"],
             int8_held=len(held_int8), **_sub_sums("int8", held_int8)),
        dict(_kernel_line("ssd_scan", f"{kernels}/ssd_scan/csrc/ssd_scan.cu",
                          "src/repro/kernels/ssd_scan/kernel.py:40",
                          ssd_launches, ssd_cases, held_ssd, library=False),
             dist_launches=dist_out["ssd_launches"],
             **_sub_sums("dist", dist_out["ssd_held"])),
        dict(_kernel_line("rber", f"{kernels}/rber/csrc/rber.cu",
                          "src/repro/kernels/rber/kernel.py:30",
                          rber_launches, [], [rber], library=False),
             wrapper_ms=rber["wrapper_ms"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
