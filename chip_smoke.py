#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

1. Device: require CUDA; print the card's name and power limit, the torch
   and CUDA versions; turn TF32 off for float32 matmuls and convolutions.
2. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (timed as
   set-up; one ``nvcc`` per source, in parallel); log ptxas's register
   and spill lines (and any wgmma serialization warning), and require
   tensor-core instructions (HMMA or HGMMA) in the SASS of the bf16
   prefill, flash and decode kernels and of every instantiation of the
   float32 prefill and flash kernels (HGMMA: ``wgmma`` on TF32; the
   tensor-core instruction counts of each logged) (``cuobjdump -sass``),
   the decode's
   group route in its full-precision, int8, participating-page and
   int8 participating-page instantiations, and the warp-specialized
   design's register
   reallocation (USETMAXREG) and TMA tensor copies (UTMALDG) in the bf16
   prefill and flash kernels, their wide kernels (head dims past 128,
   ``aqua_prefill_bf16_wide`` / ``flash_bf16_wide``) on HGMMA too; no
   spills and no serialized wgmma (ptxas C7511) in those wide kernels or
   in any float32 prefill and flash instantiation (nor any other
   serialization warning there, such as C7514); float32 FMAs (FFMA) in
   every instantiation of the decode's float32 group route and no spills
   in its ptxas lines.
3. Kernels: each kernel against its plain PyTorch version on the card, at
   the serving shapes (bf16, D=128) of Qwen3-0.6B (H=16, KV=8) and of
   Llama-3.1-8B (H=32, KV=8): decode B=8, S=4096 (contiguous, and paged
   with 64-token pages and a shuffled page table; paged also at the
   drives' contexts, lengths 128-1056 in a 2048-token table; the paged
   variants with
   int8 pools and per-(page, head) scales, with the participating pages of
   hierarchical AQUA at page_keep_ratio 0.25, and with both; each of the
   three also at the drives' contexts; the full-precision one also with
   every lane's table mapping the same first 8 pages, prefix sharing's
   tables, ``"form": "shared"``); prefill and
   flash attention B=1, S=2048, causal, and at the drives' longest prompt
   (B=1, S=1024, ``"form": "served"``: one wave of blocks, where
   per-block latency decides); flash at head_dim 80 (Danube's geometry)
   and the prefill at k_ratio 0.5 (an 8-chunk union with Dv 128), the
   shapes that take the generic kernels (``"form": "generic"``); a lane
   of length 0 beside a bucket-padded one (B=2, S=1024) in the prefill
   and flash, narrow (Qwen3-0.6B's geometry) and generic (the shapes
   above), bf16 and float32 (``"form": "empty_lane"``: each of its rows
   the mean of V, held against the plain version; zeros, the kernels'
   earlier answer, must fail); the
   prefill's ``q_offset`` form
   (chunked prefill: rows 3072-4095 of S=4096, also held against those
   rows of the monolithic call) and its participating-chunk walk
   (``_part_kernel``: B=1, S=4096, 8 of 32 key chunks of 128 per q-tile
   from ``chunk_participating_tiles`` on seeded scores; the identity table
   held against the dense walk; also under a 1024-key window); and the
   prefill's window form at H2O-Danube-1.8B's geometry (H=32, KV=8,
   D=Dv=80, B=1, S=8192, window 4096, causal; the no-window form timed on
   the same inputs). At the geometries of Qwen1.5-4B (H=20, KV=20: MHA,
   GQA group 1) and Minitron-4B (H=24, KV=8: group 3), the groups no other
   phase runs: the paged decode at S=4096 and at the drives' contexts in
   bf16 (the group route's 8-head blocks with 7 and 5 heads past the
   group) and in float32 (the float32 group route, which rounds a group
   up to 1, 2, 4 or 8 heads), and the prefill at S=2048 and 1024. At the
   MoE configs' geometry (OLMoE-1B-7B and Qwen2-MoE-A2.7B: H=16, KV=16,
   MHA): the bf16 paged decode at S=4096, at the drives' contexts, and
   there with 3 of its 8 lanes idle (length 0, no page mapped: they get
   the mean of the V slots the Pallas kernel visits, page 0's, which the
   router reads; ``"form": "idle"``), and the prefill at S=2048 and at
   S=1024 with its last 21 rows past the length (a padded admission's pad
   rows, held too: the router reads them). At Whisper-tiny's decoder
   geometry (H=6, KV=6: MHA, D=Dv=64, 6 of 8 dim-blocks selected): the
   contiguous decode at B=8 over 448 positions, lengths 37-261 (the
   drive's contexts), and the prefill at S=229 (its longest prompt, off
   the 128-row tile) and S=448. At RecurrentGemma-9B's attention geometry
   (H=16, KV=1, D=Dv=256: the engine's wide kernels, 128-column value
   slices) the prefill's window form (S=4096, window 2048; the no-window
   form timed on the same inputs, and beside it one causal SDPA call
   without a mask, PyTorch's flash backend) and flash's (the same, AQUA
   off), each also with the head fault (at one KV head no block can read
   past its group: each head's output written one head on), in bf16 and
   in float32 (the float32 routes' value slices; SDPA in float32). Flash
   at Qwen3's geometry also in a padded admission's form (``"form":
   "lengths"``: keys past the length masked, every row held; a planted
   fault drops the lengths).
   One JSON line per kernel and geometry:
   max abs error and the worst ratio of error to the per-element
   tolerance, kernel and library ms (a CUDA graph of 20 calls replayed
   between two CUDA events; a failed capture fails the phase), the
   kernel's and the plain version's ms over 20 calls from Python (CUDA
   events) and the bound (for the byte-bound decode: the bytes, and the
   achieved GB/s over them; one PyTorch sum over 256 MiB gives the card's
   practical read rate beside them; the decode, prefill and flash phases
   also give the device microseconds of each kernel a call launches (the
   decode: its partial and its combine pass), from ``torch.profiler``: the
   mean over the launches it recorded, with their number).
   Planted faults must fail the same tolerance, so it is tight enough to
   catch a wrong kernel: a lane's last 256 positions dropped, one head's
   dim-block selection shifted (decode, prefill), the first two heads of a
   KV group trading selections (decode: a kernel that gave the group's
   union, or one head's selection, to every head); ``q_offset`` one
   q_blk early; one participating key chunk swapped for a dropped one; a
   window that cuts the far keys and a causal diagonal shifted by one key
   (flash); one page's key or value scale doubled (int8); one
   participating page swapped for a dropped one (participating pages); the
   prefill's window one key wider, and its band starting one 64-key tile
   late (the participating walk over each q-tile's band without its first
   tile); lane 1's first page mapped back to its own page (shared form);
   and in every decode and prefill phase each KV group's last head
   attended against the next group's K̂ and V (q̂ and its selection rolled
   one head on, the output rolled back: a block that wrote one head past
   its group; at group 1 every head).
4. Serve Qwen3-0.6B at its full published width and depth (random bf16
   weights from a seeded generator, projections calibrated on
   ``corpora/calibration.txt``) through the continuous-batching engine, in
   seven drives of a Poisson trace (prompts 128/512/1024, 32 new tokens,
   greedy, 8 lanes): AQUA (k_ratio 0.75, block_dims 8) on the paged pool
   and on the contiguous cache; AQUA off on the paged pool (flash
   prefill); AQUA on an int8 paged pool; hierarchical AQUA
   (page_keep_ratio 0.25 of 32 pages, prompts 512/1024) on a bf16 and on
   an int8 paged pool; chunked prefill (budget 256 tokens per step,
   prompts 512/1024, every admission chunked) on the paged pool. Three
   more drives, 4 requests each, 64-token pages: H2O-Danube-1.8B at its
   published width and depth (window 4096, max_seq 8192: 4096 ring slots)
   under prompts of 4160/4480/4800/5120 tokens, every admission past the
   window; Qwen3-0.6B under H2O (h2o_ratio 0.5 of max_seq 2048: a
   1024-slot budget, 512 recents; prompts 512/1000/1024/1536); and
   AQUA-Memory (s_ratio 0.3, block_dims 2: 90 of 128 dims kept, stored
   as 96; prompts 128/512/1024), whose KV bytes are reported against the
   full-width pool. Three int8 drives: ``int8_swa_paged`` (``swa_paged``
   on int8 pools: decode on a wrapped ring, a re-entered page's running
   scale only growing, as in JAX), ``int8_h2o_paged`` (``h2o_paged`` on
   int8 pools: an evicted page's scales cleared) and ``hot_int8_paged``
   (Qwen3-0.6B, int8 pools with ``hot_resident_fraction`` 0.25: 64 of the
   256 pages also kept in bf16, each admission promoting its lane's
   freshest page; 4 requests of 128/512/1024 tokens; its resident count
   and the promotions seen are printed); resident decode runs the
   masked-dense core over the dequantized, overlaid lane view, as in JAX.
   Their pool bytes are printed against the bf16 drive of the same
   geometry (the ring's and H2O's must stay below 0.60 of it, the
   resident pool between the int8 pool's share and 1). And
   ``prefix_paged``: prefix sharing on (the other
   paged drives turn it off), 8 requests whose prompts are one 512-token
   prefix and a tail of 128/512/1024 tokens (640/1024/1536): 7
   admissions must map the first prompt's 8 prefix pages and prefill
   only their tails (3584 prefill tokens saved), its pool's peak pages
   must stay below the same trace's served unshared (both reported), and
   its trace served again (the fresh admission replays its graph) must
   give the same tokens; the host ms of a shared (eager) and a fresh
   admission are reported. Window and H2O decode run the masked-dense core, as
   in JAX. The peak device memory of the window, H2O, AQUA-Memory and
   three int8 drives is reported. The
   launch counters are zeroed just before each drive and read just after
   it: each drive must have launched its prefill kernel once per layer
   per fresh monolithic admission and per prefill chunk (none for a
   prefix-shared admission, whose tail runs the reference chunk step as
   in JAX), its decode kernel once per layer per decode step, and no
   other kernel. Each trace is also
   served by its reference (the kernels' plain versions, backend
   ``aqua-block-sparse-plain``; for AQUA off the ``dense`` backend): every
   admission's logits and those of the first decode steps (on lanes whose
   tokens, and under a window or H2O every layer's kept positions, still
   agree) must match within a stated bf16 limit; the greedy token match,
   and each lane's first step with other kept positions, are reported. The chunked trace is also served
   monolithically with the kernels: token match, and the inter-token gaps
   and admission ms of each engine's second serve, are reported. The int8 pool must take < 0.60 of the bf16 pool's
   bytes. Every drive, the reference drives too, decodes through the
   engine's captured decode step (``serving/step_graph.py``: one CUDA
   graph per engine, captured at its first serve and replayed every
   step); each drive reports its decode-step ms, the capture's host ms
   and the graph pool's bytes. Every bucket-padded monolithic admission
   of a drive (all but the window, H2O and chunked ones) goes through the
   engine's admission graph of its prompt bucket
   (``serving/admit_graph.py``: captured at the bucket's first
   admission, replayed after); each drive reports its admission ms, its
   admission graphs, their capture ms by bucket and their shared pool's
   bytes beside the step graph's. The paged drive's trace is served
   again on its engine (every bucket captured: every admission replays):
   its tokens must be the first serve's and its launches the path's; its
   admission ms and inter-token gaps are reported. A paged drive of 4
   requests runs under ``torch.profiler`` for the device's idle share and
   its top kernels, in a child process that runs before the kernel
   phases (``chip_smoke.py --traced-drive OUT``: the paged drive's
   engine, its trace served once to capture its graphs, then the traced
   drive and one traced replay of its step graph and of its largest
   admission graph, for their device operations; a crash of the child
   fails the run, see ``traced_drive``); the idle share is reported only
   from a trace that holds every decode launch the drive counted (the
   replayed graph's kernels are traced one by one), else as not
   measured.
5. Step graph: for the paged, int8, hierarchical int8, H2O, window,
   prefix-sharing and the three int8 drives above, and the two configs'
   drives of 5b, the drive's prompts are admitted at once, the
   state is cloned, and 16 decode steps with seeded tokens and write
   masks run through the engine's step graph on one copy and eager
   ``model.decode_step`` on the other: logits and every state tensor must
   be equal bit for bit. Two
   planted faults must break that equality: replays that skip the copy
   of the tokens (the graph reads the previous step's) and replays that
   skip the copy of the write mask. Device ms of a replay: 16 replays
   between two CUDA events.
   Admission graphs: for the paged, contiguous, flash, int8, hierarchical
   (bf16 and int8), AQUA-Memory and hot-resident drives (the last
   promotes a resident inside the graph), and in phase 6 the HF drive
   (float32), two admissions per bucket in the reverse of the capture
   order, into other lanes and pages, replayed on the engine's state and
   run eagerly (``admit_graph.admission``) on a clone: logits and every
   state tensor equal bit for bit after each. Two planted faults must
   break it: the second admission of a bucket replayed with the first's
   lane, or its length, left in the graph's buffer. Reported: capture ms
   and pool growth by bucket, the shared pool's bytes, host ms of an
   admission replayed and eager, device ms of the largest bucket's replay
   (16 between two CUDA events) and its device operations.
5b. Qwen1.5-4B and Minitron-4B at their published widths and depths
   (random bf16 weights, calibrated projections), each loaded, driven and
   freed before the next: 4 requests of 128/512/1024 tokens, 4 lanes,
   64-token pages, AQUA; logits within LOGIT_RTOL of the plain drive,
   exactly the prefill once per layer per admission and the paged decode
   once per layer per step, the step graph bit for bit (phase 5); their
   launches, KV bytes and peak memory are printed. Then the MoE family,
   the same way: OLMoE-1B-7B (16 layers, 64 experts, top-8) at 4 lanes
   and Qwen2-MoE-A2.7B (24 layers, 60 experts, top-4, shared experts) at
   8 lanes and 8 requests, at capacity factor 1.25, with prompts of
   121/509/1003 tokens (off the 16-token bucket: admissions route pad
   rows). Each drive records every layer's routing on a
   ``models.moe.RoutingTape`` (which the graphs capture). Against the
   plain drive that routes by itself, logits are compared on the
   admissions whose every token, and the decode rows whose admission and
   every checked step, both drives routed alike; the rows this excluded
   are printed (a bf16 rounding flips near-tied experts and capacity
   drops: at full width every row has such a flip, PERF.md). A second
   plain drive replays the kernel drive's routing (the tape, call for
   call: the same experts and drops, its own gate weights): every
   admission's and checked decode row's logits within LOGIT_RTOL. The
   routing choices dropped per admission and per decode step in both
   drives, pad rows and idle lanes included, and the real tokens' per
   admission are printed. Their admission graphs
   are held to eager admissions (phase 5), their step graph (on an
   engine without a tape) too, and the decode step's ms
   beside its byte bound (every layer's weights, all experts since
   JAX's dense capacity buffers run every expert, the float32
   unembedding and the lanes' K̂ and V, at 3.35 TB/s) is printed.
5c. The modality-frontend families at their published widths and depths
   (random bf16 weights, calibrated projections, each loaded, driven and
   freed in turn): Pixtral-12B (40 layers, d 5120, 32 / 8 heads; 4 lanes,
   64-token pages; 4 requests of 300/700/1000 prompt tokens, each with
   its own 256 patch embeddings of width 1024, projected by
   ``patch_proj`` and spliced over its first positions; calibrated on
   320-token windows, which hold the patches) and Whisper-tiny (4 + 4
   layers, d 384; 8 lanes, contiguous cache, max_seq 448; 8 requests of
   37/101/229 decoder tokens, each with its own 1500 frames; exact-length
   eager admissions). Each against its plain drive (logits within
   LOGIT_RTOL), launches exactly the path's (the encoder and the
   cross-attention run no kernel, as in JAX), the step graph bit for bit
   (Whisper's with a third fault: each lane reading its neighbour's cross
   K/V), Pixtral's admission graphs with patches bit for bit (a third
   fault: a replay keeping the previous admission's patches), the decode
   step's graph replay beside its byte bound and the peak memory printed.
5d. The recurrent families at their published widths and depths (random
   bf16 weights, each loaded, driven and freed in turn; contiguous cache,
   exact-length eager admissions): RecurrentGemma-9B (38 layers: 26
   RG-LRU blocks and 12 local attention blocks of 16 heads over one KV
   head of 256 dims, window 2048; d 4096; 4 lanes, max_seq 4096, 4
   requests of 1024/2100/3000 prompt tokens, two past the window; AQUA
   k_ratio 0.75, block_dims 8, projections calibrated through
   ``forward(capture=True)``): launches exactly the prefill's wide kernel
   once per attention layer per admission and no decode kernel (a
   windowed attention decodes on the masked-dense core, as in JAX); it
   records its dim-block selections and is held to a plain drive
   replaying them (every row within LOGIT_RTOL), a self-selecting plain
   drive reported beside; its step graph bit for bit with a third fault
   (the RG-LRU state put back after each replay: a stale recurrent
   state); then with AQUA off, flash's wide kernel once per attention
   layer per admission, against the ``dense`` drive. Then
   ``recurrentgemma-9b_f32``: the same trace on RecurrentGemma-9B at full
   width, depth cut to 6 layers (two recurrent, recurrent, attention
   groups), float32 params and activations: the float32 prefill exactly
   once per attention layer per admission, held to a plain drive
   replaying its selections at the float32 drives' limit (phase 6's
   HF_LOGIT_SCALE), and AQUA off (float32 flash, exactly, against
   ``dense`` at that limit). Mamba-2-370M (48
   SSD layers, d 1024; 8 lanes, 8 requests of 128/512/1024 tokens; no
   AQUA, as in JAX): no kernel launched; each admission's and checked
   decode row's logits against the request alone on a ``ServeEngine``
   fed the same tokens with its decode steps at the engine's 8 rows
   (held within LOGIT_RTOL), and at one row (reported: cuBLAS rounds a
   bf16 product of one row otherwise than one of eight, and 48 random
   recurrent layers amplify it); its step graph bit for bit with a stale
   SSD-state fault. Both print the decode step's graph replay beside its
   byte bound (the weights, the float32 unembedding, the rings' K̂ and V,
   the recurrent states read and written) and the peak memory.
6. HF checkpoint through the port's entry point: a synthetic checkpoint
   in HF layout at Qwen3-0.6B's full width and depth (random bf16 weights
   from a seeded generator, tied, two shards plus the index; written to
   ``build/hf_qwen3_0_6b`` and deleted after the phase; bytes and seconds
   to write and load printed) is served by ``repro_torch.launch.serve.main``
   in-process: ``--calibration-corpus corpora/calibration.txt --k-ratio
   0.75 --block-dims 8 --page-size 64 --lanes 8
   --requests 8 --prompt-lens 128,512,1024 --steps 32 --max-seq 2048
   --verify`` (greedy tokens identical to the contiguous reference engine,
   the pool-bytes check; the launcher prints its own lines). Its params and
   activations are float32 (``config_from_hf``), so the drive runs the
   float32 routes: the decode's float32 group route and the prefill on
   TF32 tensor cores in three passes. The launcher's own run launches,
   exactly: the prefill kernel
   once per layer per admission of its drive and of its reference drive
   and per calibration batch, the paged decode once per layer per step of
   its drive, the contiguous decode once per layer per step of the
   reference drive, nothing else. The launcher's engine then serves the
   trace again (its second serve through the captured step graph: the
   same tokens) with the counters zeroed just before and read just after:
   the prefill kernel once per layer per admission, the paged decode once
   per layer per step, nothing else; its admission ms and gaps are
   printed, and its admission graphs held to eager admissions (phase 5). A plain reference drive
   (``aqua-block-sparse-plain``) on the same loaded params: every
   admission's and the first 16 decode steps' logits within |got - want|
   <= HF_LOGIT_SCALE * (F32_RTOL * |want| + F32_ATOL). A control drive,
   the plain drive with every attention input rounded to bf16, must
   break that limit. The launcher again on the same checkpoint at its
   default ``--block-dims 1`` (per-dim selection) with ``--verify``:
   prefill runs flash on the masked q̂, decode the masked-dense core, so
   the run launches, exactly, flash once per layer per admission of its
   drive and of its reference drive and per calibration batch, nothing
   else; its logits against a plain drive are reported, not held (per-dim
   selection parts the drives at near-tied dim ranks). The launcher a
   third time, the first call's flags without ``--block-dims 8`` (so at
   its default 1) and with ``--shared-prefix-len 512`` (prompts of
   640/1024/1536 tokens): ``--verify`` (tokens identical to the
   contiguous reference, and its prefix gate), 7 admissions reusing the
   shared prefix, and exactly flash once per layer per fresh admission of
   its drive (one) and per admission of its reference drive and per
   calibration batch. (The first two calls' random prompts share no
   page: prefix sharing, on by default, changes nothing there.) The
   launcher's engine's step graph against eager ``decode_step``, bit for
   bit, with its device ms per replay (phase 5's check, in float32).
   The float32 routes at the drives' shapes (decode B=8 over a
   2048-token table, lengths 128-1056, paged and contiguous, both on the
   float32 group route; prefill and flash B=1, S=1024)
   against their plain versions with the planted faults of the bf16
   phases, timed the same way, with SDPA in float32 as the library call;
   float32 bounds at the faster of 67 TFLOP/s outside the tensor cores
   and a third of 495 TFLOP/s TF32 (three passes).
7. Training and the evaluation path (``{"train": ...}`` and ``{"eval":
   ...}`` lines). (a) Qwen3-0.6B at its full width and depth (28 layers,
   d 1024, vocab 151936; float32 params, bf16 compute, remat) trained 10
   steps through ``Trainer.run`` at JAX's CLI defaults (batch 8 of 64
   tokens, lcg data, warmup 1), the launch counters zeroed before and
   read after: no kernel launched (``auto`` under grad is ``dense``);
   every loss finite, the last below the first; the step's wall-clock ms
   (synchronized; the step is host-bound, and ``train_profile.py`` reads
   the device's busy time), median of steps 2-10, tokens/s, peak memory
   beside the state reckoned from the shapes (params, grads, two
   moments: 16 bytes a param), the step's bounds (operations at 989
   TFLOP/s; the optimizer's float32 passes at 3.35 TB/s). On the first
   step's params and batch: bf16-compute gradients against a
   float32-compute step (the loss within GRAD_LOSS_RTOL, every leaf's
   cosine at least GRAD_COS_MIN, the global norm within GRAD_NORM_RTOL);
   the planted fault, each block's attention output detached (what an
   unguarded kernel would give autograd), must fail them; the same
   forward on ``flash`` must raise the guard's ``NotImplementedError``.
   (b) JAX's bench model (``benchmarks/common.py``: reduced Qwen3-0.6B,
   vocab 128, d_model 96, 4 / 2 heads of 24, float32) trained 400 steps
   on the copy task (sequence 64, batch 16, lr 3e-3, warmup 20; no kernel
   launched) and calibrated on ``calibration_batches``; ``ServeEngine.
   score`` on 4 held-out batches (seed0 50 000) with AQUA off and at
   k_ratio 0.75 and 0.5 (block_dims 8), the counters zeroed before and
   read after: flash, then the prefill kernel, once a layer a batch; each
   score within F32_RTOL * |plain| + F32_ATOL of the plain backend's; the
   copied half's ppl with AQUA off at most COPY_PPL_MAX; greedy tokens of
   the continuous-batching engine (k_ratio 0.5) continuing the copy (at
   least COPY_MATCH_MIN of them); a checkpoint resume (4 steps, a save
   to a temporary directory, a fresh ``Trainer`` that restores, 4 more)
   against 8 straight steps within RESUME_RTOL.
7b. Serving on a mesh (the ``{"serve_mesh": ...}`` line). Two ranks on
   the card ask NCCL for a communicator (what it says is recorded); then
   the kernels, built once here, serve on four spawned ranks, a 2x2 data
   x model mesh sharing the card over gloo. Qwen3-0.6B at full width and
   depth, random weights from MESH_SEED made on the host, each rank's
   blocks copied to the card (``bridge.params_from_numpy(mesh=)``), AQUA
   k 0.75 bd 8 calibrated on the host by rank 0; 8 lanes (4 a rank),
   64-token pages, the prefix_paged trace; float32 with prefix sharing,
   bf16 without. Every rank: a mesh-native plan, no fallback, eager
   steps, exactly the path's launches (the prefill once a layer a fresh
   admission, the paged decode once a layer a step), the same tokens as
   every other rank. Rank 0: the prefill and the paged decode against
   their plain versions at the rank's shard-local shapes (8 heads over 4
   KV heads, 4 lanes; ``mesh_shard_form`` in the kernels line); the
   trace on one device with the kernels and with their plain versions,
   the mesh's logits held to both by request (float32: HF_LOGIT_SCALE
   times the float32 limit, and the kernels' tokens exactly; bf16:
   LOGIT_RTOL); in bf16 each request whose tokens part from one device's
   shown against a float32-activation forward at the parting token
   (``parted_rows``). Bf16 also: every rank's KV shard swapped for its
   model peer's must break the limit; and the trace on a data-only 4x1
   mesh of the same ranks, whose step and admissions run as CUDA graphs,
   with exactly the path's launches on every rank, held to one device at
   LOGIT_RTOL.
7c. This slice's drives on the same 2x2 mesh, in the same four ranks
   (``MESH_POLICY_DRIVES``; the ``[serve_mesh NAME]`` lines and the
   ``policies`` of the ``serve_mesh`` line): Qwen3-0.6B uncut on int8
   pools (scales per page and KV head; mesh-native), with hot residents
   (a quarter of the pool; decode on the masked-dense core and
   ``REASON_QUANT_RESIDENCY`` recorded, as in JAX) and, depth cut to 8,
   hierarchical int8 (page_keep_ratio 0.25); H2O-Danube-1.8B uncut with
   its 4096-token window, max_seq 8192, prompts past the window (decode
   on the wrapped ring, ``REASON_WINDOW``); OLMoE-1B-7B uncut, expert
   parallel (32 experts a rank, ``w2`` on f, every decode step's 8 lanes
   gathered and routed as one block); Pixtral-12B at full width, depth
   cut to 10, 256 patch embeddings a request. 4 requests of 16 new
   tokens, about 24 decode steps. The ranks take turns making the whole
   model on the card from the single-device drives' seed and keep their
   blocks; rank 0 calibrates. Every rank: JAX's plan and fallback
   events, eager steps, exactly the path's launches, the same tokens as
   every other rank, step and admission ms, peak memory. Rank 0: the
   trace on one device with the kernels and with their plain versions
   (the mesh's lane order), the mesh held to both by request at
   LOGIT_RTOL (MoE: against the self-routed kernel drive a row up to its
   first other route, the excluded rows counted; the plain drive replays
   the mesh's routing, every row held), parted rows against a float32
   forward, and the drive's kernels against their plain versions at the
   rank's shapes with their planted faults (``mesh_shard_form``). The
   int8 drive's fault: every rank's page scales swapped for its model
   peer's after two admissions must break the limit.
8. The ``{"kernels": [...]}`` line (the paged decode's and the prefill's
   phases at groups 1 and 3 and at the MoE geometry under
   ``group_geometries``, with the launches of those configs' drives;
   flash's padded-admission form under ``lengths_form``, with the flash
   drive's launches; each float32 route under its kernel's
   ``float32_route``, with its launches on its path: the paged decode's
   and the prefill's in the HF drive's second serve, the contiguous
   decode's in the launcher's ``--verify`` reference engine, flash's in
   the ``--block-dims 1`` run), then
   the ``{"ok": true, ...}`` line. Every kernel also lists its launches
   in each config drive of 5b and 5c (``launches_by_config``); the
   Whisper-geometry phases stand under ``group_geometries`` with the
   Whisper drive's launches; the prefill's and flash's wide kernels at
   RecurrentGemma-9B's geometry under ``wide_form`` (bf16) and
   ``wide_form_float32``, with the launches of the hybrid's AQUA and
   AQUA-off drives in that dtype; the length-0 checks under
   ``empty_lane_form``; ``launches_by_path`` adds the score
   path's launches (``score``) and the training runs' (``train``: none).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM dense TF32 tensor-core peak
# float32 work held at float32 accuracy: on scalar float32, or on TF32
# tensor cores as three passes (x = hi + lo: lo·hi + hi·lo + hi·hi),
# whichever is faster; the float32 bounds use this rate
F32_ACCURATE_OPS_PER_S = max(F32_OPS_PER_S, TF32_OPS_PER_S / 3)
K_RATIO, BLOCK_DIMS = 0.75, 8
# bf16 outputs, per element |out - ref| <= KERNEL_RTOL * |ref| +
# KERNEL_ATOL: kernel and plain version both compute in float32 from the
# same inputs (in different summation orders) and round once to bf16, so
# they may differ by one bf16 ulp, at most 2^-7 * |ref|; KERNEL_ATOL covers
# the float32 difference near zero. Decode outputs average thousands of V
# rows (|out| ~ 0.02), so an absolute limit alone would be too loose.
KERNEL_RTOL, KERNEL_ATOL = 2.0 ** -7, 1e-4
# float32 outputs (the int8 decode variants): both sides compute in float32
# in different summation orders over at most 4096 rows
F32_RTOL, F32_ATOL = 1e-5, 1e-5
# logits of the bf16 model through 28 layers: kernel and plain attention
# outputs differ by about one bf16 ulp per layer; each row's logits must
# stay within 5% of that row's largest magnitude
LOGIT_RTOL = 0.05
# the float32 model's logits through 28 layers (the hf_serve drive against
# its plain reference drive), per logit |got - want| <= HF_LOGIT_SCALE *
# (F32_RTOL * |want| + F32_ATOL): near the geometric middle of the sound
# drive's largest reading (0.984 of the unscaled limit) and that of a
# control drive whose attention reads its inputs at bf16 precision (6134),
# about 80x from each (PERF.md)
HF_LOGIT_SCALE = 80.0
DECODE_STEPS_CHECKED = 16


T_START = time.perf_counter()


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def log_time(stage: str) -> None:
    """Wall-clock seconds since the script started, after ``stage``."""
    log(f"[time] {stage}: {time.perf_counter() - T_START:.1f} s")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """ms per call of ``iters`` calls made from Python between two CUDA
    events: at ~0.1 ms a call this is the host's call rate, not the
    device's time (see :func:`graph_ms`)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph
    after a warm-up, replayed once untimed and once between two events,
    so no host work lies between the launches. A failed capture raises."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def timings(kernel, plain, library, plain_iters: int = 20) -> dict:
    """A kernel phase's times: kernel and library calls from a replayed
    CUDA graph (``ms``, ``library_ms``), the plain version from a Python
    loop, and the kernel's Python-loop time beside its graph time."""
    return dict(ms=graph_ms(kernel), loop_ms=cuda_ms(kernel),
                plain_ms=cuda_ms(plain, iters=plain_iters),
                library_ms=graph_ms(library))


def device_us(fn, calls: int = 10) -> dict:
    """Device microseconds of each kernel ``fn`` launches (the decode: its
    partial pass and its combine pass), from ``torch.profiler`` over
    ``calls`` calls: per kernel, the mean over the launches the profiler
    recorded and their number: late in a long run it may record only some
    of them, and a sum over the calls would then undercount (PERF.md)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = re.split(r"[<(]", e.name.replace(
                "(anonymous namespace)::", "").removeprefix("void "))[0]
            name = name.split("::")[-1]
            rec = by_name.setdefault(name, {"us": 0.0, "events": 0})
            rec["us"] += e.time_range.elapsed_us()
            rec["events"] += 1
    for rec in by_name.values():
        rec["us"] /= rec["events"]
    return by_name


SASS_OPS = ("HMMA", "HGMMA", "USETMAXREG", "UTMALDG", "FFMA")


def sass_counts(lib: str) -> dict:
    """Instructions of each opcode in ``SASS_OPS`` (tensor cores: HMMA,
    HGMMA; register reallocation: USETMAXREG; TMA tensor copies: UTMALDG;
    float32 FMAs outside the tensor cores: FFMA) per kernel function in
    the SASS of one built library, from ``cuobjdump -sass``."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    counts, fn = {}, None
    pats = {op: re.compile(rf"\b{op}\b") for op in SASS_OPS}
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            for op, pat in pats.items():
                if pat.search(line):
                    counts[fn][op] += 1
    return counts


def ptxas_spills(log: str) -> dict:
    """Spill stores plus spill loads in bytes per kernel function, from
    the ptxas lines of one nvcc build (``-Xptxas -v``)."""
    spills, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            spills[fn] = int(m.group(1)) + int(m.group(2))
            fn = None
    return spills


def ptxas_serialized(log: str) -> list:
    """Kernel functions whose wgmmas ptxas serialized for want of registers
    (warning C7511), from the ptxas lines of one nvcc build."""
    return re.findall(r"C7511\).*in the function '(\S+?)'", log)


def ptxas_any_serialized(log: str) -> list:
    """Kernel functions whose wgmmas ptxas serialized for any reason
    (C7511, or C7514: accumulators read while their products ran), from
    the ptxas lines of one nvcc build."""
    return re.findall(r"wgmma\.mma_async instructions are serialized.*in the "
                      r"function '(\S+?)'", log)


def tol_ratio(out, ref) -> float:
    """Worst ratio of |out - ref| to the per-element tolerance of out's
    dtype (<= 1 is within it)."""
    import torch
    rtol, atol = ((F32_RTOL, F32_ATOL) if out.dtype == torch.float32
                  else (KERNEL_RTOL, KERNEL_ATOL))
    ref = ref.float()
    return ((out.float() - ref).abs()
            / (rtol * ref.abs() + atol)).max().item()


def check_kernel(out, ref, faults: dict) -> dict:
    """Error of ``out`` against ``ref``, and the same for each planted
    fault's output, which must fall outside the tolerance."""
    ratio = tol_ratio(out, ref)
    caught = {name: tol_ratio(f, ref) for name, f in faults.items()}
    return dict(max_abs_err=(out.float() - ref.float()).abs().max().item(),
                tol_ratio=ratio, fault_tol_ratios=caught,
                ok=ratio <= 1.0 and all(r > 1.0 for r in caught.values()))


def shifted(block_idx, nb: int):
    """``block_idx`` with lane 0, head 0 (and chunk 0) choosing every
    selected block one further, mod ``nb``: a planted selection fault."""
    import torch
    bad = block_idx.clone()
    first = (0,) * (bad.ndim - 1)
    bad[first] = torch.sort((bad[first] + 1) % nb)[0]
    return bad.contiguous()


def bound(nbytes: float, ops: float, ops_per_s: float = BF16_OPS_PER_S
          ) -> tuple:
    """The least time (ms) for ``nbytes`` of device memory traffic and
    ``ops`` operations at ``ops_per_s`` (bf16 tensor cores by default;
    float32 work at ``F32_ACCURATE_OPS_PER_S``), and which of the two
    bounds it."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def byte_rate(nbytes: float, ms: float) -> dict:
    """The bytes a byte-bound kernel must move and its achieved rate over
    them (GB/s), beside its bound."""
    return dict(bound_bytes=nbytes, achieved_gbs=nbytes / ms * 1e-6)


def read_rate() -> dict:
    """The card's practical read rate: one PyTorch sum over 256 MiB of
    bf16 (GB/s, from a replayed CUDA graph), beside the 3.35 TB/s that the
    byte bounds use."""
    import torch
    x = torch.ones(2 ** 27, device="cuda", dtype=torch.bfloat16)
    ms = graph_ms(lambda: x.sum())
    return dict(bytes=2 * x.numel(), ms=ms, gbs=2 * x.numel() / ms * 1e-6)


def heads_past_group(kernel, q, block_idx, **kw):
    """A planted fault: the kernel's output with q̂ and its selection rolled
    one head on and the output rolled back, so that each KV group's last
    head is attended against the next group's K̂ and V, as a block that
    wrote one head past its group would leave it (at group 1 every head
    takes its neighbour's KV head). Head axis 1 of q̂, selection and
    output."""
    out = kernel(q=q.roll(1, 1).contiguous(),
                 block_idx=block_idx.roll(1, 1).contiguous(), **kw)
    return out.roll(-1, 1)


def head_fault(kernel, q, block_idx, kvh: int, **kw) -> dict:
    """The planted head fault of a phase: ``heads_past_group`` where there
    is a next KV group; at one KV head (RecurrentGemma's MQA) no block can
    read past its group, and the nearest fault is each head's output
    written one head on (``heads_one_on``: q̂ and its selection rolled one
    head, the output left there)."""
    if kvh > 1:
        return {"heads_past_group": heads_past_group(kernel, q, block_idx,
                                                     **kw)}
    extra = {} if block_idx is None else {
        "block_idx": block_idx.roll(1, 1).contiguous()}
    return {"heads_one_on": kernel(q=q.roll(1, 1).contiguous(), **extra,
                                   **kw)}


def swapped_group_heads(block_idx):
    """``block_idx`` with lane 0's first two heads (of KV group 0) trading
    their selections: a planted fault that a kernel applying the group's
    union, or one head's selection, to every head of the group misses."""
    bad = block_idx.clone()
    assert not bad[0, 0].equal(bad[0, 1]), "heads 0 and 1 select alike"
    bad[0, [0, 1]] = block_idx[0, [1, 0]]
    return bad.contiguous()


# ---------------------------------------------------------------------------
# Kernel phases
# ---------------------------------------------------------------------------


def decode_phase(geom: str, h: int, kvh: int, paged: bool, gen,
                 s: int = 4096, len_range: tuple = (2048, 4096),
                 form: str = None, dtype: str = "bfloat16",
                 shared_pages: int = 0, idle: int = 0, d: int = 128,
                 b: int = 8) -> dict:
    """The decode (contiguous or paged, 64-token pages) at B=``b`` (8) over
    a table of ``s`` positions, lengths uniform in ``len_range``; the served
    form (``form="served"``) takes the drives' contexts. bf16 takes the
    group route; float32 (``dtype``, the served checkpoint's) the float32
    group route (``group_f32``). ``shared_pages`` > 0 (paged): every
    lane's table maps lane 0's first ``shared_pages`` physical pages, as
    prefix sharing maps a shared prompt prefix, with one more planted
    fault, lane 1's first page mapped back to its own (unshared) page; the
    bound then counts the shared rows once. ``idle`` > 0: the last
    ``idle`` lanes are idle lanes of a decode step (length 0, paged: no
    page mapped), which get the mean of the V slots the Pallas kernel
    visits (page 0's, or their own stripe's): an MoE routes them with the
    live lanes. ``d``: the head dim (D = Dv)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import aqua
    from repro_torch.kernels import aqua_decode as dk
    from repro_torch.kernels.ops import round_k_dims

    ps = 64
    dev, bf = "cuda", getattr(torch, dtype)
    q = torch.randn(b, h, d, device=dev, generator=gen).to(bf)
    k = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(bf)
    v = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(bf)
    lengths = torch.randint(len_range[0], len_range[1] + 1, (b,),
                            device=dev, generator=gen, dtype=torch.int32)
    if idle:
        lengths[b - idle:] = 0
    scale = d ** -0.5
    nsel = round_k_dims(d, K_RATIO, BLOCK_DIMS)
    block_idx = aqua.topk_block_indices(q, nsel, BLOCK_DIMS).contiguous()
    nb = d // BLOCK_DIMS
    cut = lengths.clone()
    cut[0] = max(int(cut[0]) - 256, 1)  # lane 0 loses its last 256 rows
    if paged:
        npl = s // ps
        perm = torch.randperm(b * npl, device=dev, generator=gen)
        table = perm.reshape(b, npl).to(torch.int32)
        # pool page table[b, j] holds lane b's logical page j
        k_pool = torch.empty(b * npl, kvh, ps, d, device=dev, dtype=bf)
        v_pool = torch.empty_like(k_pool)
        k_pool[table.long()] = k.reshape(b, kvh, npl, ps, d).transpose(1, 2)
        v_pool[table.long()] = v.reshape(b, kvh, npl, ps, d).transpose(1, 2)
        own = table.clone()
        table[:, :shared_pages] = table[0, :shared_pages]
        if idle:
            table[b - idle:] = -1

        def kernel(block_idx=block_idx, lengths=lengths, table=table, q=q):
            return dk.aqua_paged_decode_attention(
                q, k_pool, v_pool, block_idx, table, lengths,
                block_dims=BLOCK_DIMS, scale=scale)

        def plain():
            return dk.aqua_decode_plain(q, k_pool, v_pool, block_idx,
                                        lengths, table,
                                        block_dims=BLOCK_DIMS, scale=scale)
    else:
        def kernel(block_idx=block_idx, lengths=lengths, q=q):
            return dk.aqua_decode_attention(q, k, v, block_idx, lengths,
                                            block_dims=BLOCK_DIMS,
                                            scale=scale)

        def plain():
            return dk.aqua_decode_plain(q, k, v, block_idx, lengths, None,
                                        block_dims=BLOCK_DIMS, scale=scale)

    faults = {"dropped_split": kernel(lengths=cut),
              "shifted_block": kernel(block_idx=shifted(block_idx, nb)),
              "swapped_group_heads": kernel(
                  block_idx=swapped_group_heads(block_idx)),
              "heads_past_group": heads_past_group(kernel, q, block_idx)}
    if shared_pages:
        unshared = table.clone()
        unshared[1, 0] = own[1, 0]
        faults["lane_1_first_page_unshared"] = kernel(table=unshared)
    check = check_kernel(kernel(), plain(), faults)
    # yardstick: one library call on the equivalent masked-q̂ dense problem
    sel = torch.zeros(b, h, d // BLOCK_DIMS, device=dev)
    sel.scatter_(-1, block_idx.long(), 1.0)
    qm = (q * sel.repeat_interleave(BLOCK_DIMS, -1).to(bf))[:, :, None]
    mask = (torch.arange(s, device=dev)[None, :] < lengths[:, None])[
        :, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qm, k, v, attn_mask=mask,
                                              scale=scale, enable_gqa=True)

    # bytes this run needs: per (lane, kv head) the union of the dim-blocks
    # its G heads selected, over the valid rows, plus the valid V rows
    g = h // kvh
    per_lane = sel.reshape(b, kvh, g, -1).amax(dim=2)        # (B, KV, NB)
    union = per_lane.sum(dim=-1)                              # (B, KV)
    lens = lengths.double()
    # shared pages' rows are one set of rows, read once for the union of
    # every lane's selections; each lane reads its private rows
    shared_rows = lens.clamp(max=shared_pages * ps)
    el = q.element_size()
    nbytes = el * float(((lens - shared_rows)[:, None]
                         * (union * BLOCK_DIMS + d)).sum())
    nbytes += el * float(shared_rows.max()) * float(
        (per_lane.amax(dim=0).sum(dim=-1) * BLOCK_DIMS + d).sum())
    nbytes += el * (q.numel() + b * h * d) + 4 * (block_idx.numel() + b)
    # an idle lane's mean reads page 0's V rows (or its own stripe's) once
    nbytes += el * idle * kvh * d * (ps if paged else s)
    ops = 2 * float(lens.sum()) * h * (nsel + d)
    bms, by = bound(nbytes, ops, BF16_OPS_PER_S if el == 2
                    else F32_OPS_PER_S)
    name = "aqua_paged_decode" if paged else "aqua_decode"
    times = timings(kernel, plain, library)
    times["device_us"] = device_us(kernel)
    return dict(name=name, geometry=geom, form=form, dtype=dtype,
                route=dk.decode_route(bf, quant=False, part=False, d=d, dv=d,
                                      nsel=nsel),
                shape=dict(B=b, H=h, KV=kvh, S=s, D=d,
                           page_size=ps if paged else None,
                           lengths=list(len_range),
                           shared_pages=shared_pages, idle_lanes=idle),
                **check, **times, bound_ms=bms, bound_by=by,
                **byte_rate(nbytes, times["ms"]))


def attention_route(element_size: int) -> str:
    """The prefill's and flash's route for an element size: bf16 on
    ``wgmma``, float32 on ``wgmma`` with three TF32 passes."""
    return "wgmma" if element_size == 2 else "tf32x3_wgmma"


def prefill_phase(geom: str, h: int, kvh: int, gen, s: int = 2048,
                  form: str = None, k_ratio: float = K_RATIO,
                  dtype: str = "bfloat16", pad: int = 0,
                  d: int = 128) -> dict:
    """The prefill, B=1, causal, over ``s`` rows (any count: the last
    q-tile may be partial); the served form (``form="served"``) at the
    drives' longest prompt. bf16 runs on ``wgmma``; float32 (``dtype``,
    the served checkpoint's) on ``wgmma`` in three TF32 passes.
    ``pad`` > 0: a bucket-padded admission, the last ``pad`` rows past
    the length, held too (they see every valid key; an MoE routes them
    with the real rows). ``d``: the head dim (D = Dv)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import aqua
    from repro_torch.kernels import aqua_prefill as pk
    from repro_torch.kernels.ops import round_k_dims

    b, q_blk = 1, 128
    dev, bf = "cuda", getattr(torch, dtype)
    q = torch.randn(b, h, s, d, device=dev, generator=gen).to(bf)
    k = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(bf)
    v = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(bf)
    lengths = torch.full((b,), s - pad, dtype=torch.int32, device=dev)
    scale = d ** -0.5
    nsel = round_k_dims(d, k_ratio, BLOCK_DIMS)
    nqc = -(-s // q_blk)
    block_idx = aqua.chunk_topk_block_indices(
        F.pad(q, (0, 0, 0, nqc * q_blk - s)), nsel, BLOCK_DIMS, q_blk,
        lengths).contiguous()
    kw = dict(block_dims=BLOCK_DIMS, q_blk=q_blk, causal=True, scale=scale)

    def kernel(block_idx=block_idx, q=q):
        return pk.aqua_prefill_attention(q, k, v, block_idx, lengths, **kw)

    def plain():
        return pk.aqua_prefill_plain(q, k, v, block_idx, lengths, **kw)

    check = check_kernel(kernel(), plain(), {
        "shifted_block": kernel(shifted(block_idx, d // BLOCK_DIMS)),
        "heads_past_group": heads_past_group(kernel, q, block_idx)})
    sel = torch.zeros(b, h, nqc, d // BLOCK_DIMS, device=dev)
    sel.scatter_(-1, block_idx.long(), 1.0)
    qmask = sel.repeat_interleave(BLOCK_DIMS, -1).repeat_interleave(
        q_blk, 2)[:, :, :s]
    qm = q * qmask.to(bf)

    def library():
        return F.scaled_dot_product_attention(qm, k, v, is_causal=True,
                                              scale=scale, enable_gqa=True)

    pairs = s * (s + 1) / 2
    ops = 2 * pairs * h * (nsel + d)
    # q's selected dims, all of K̂ (the chunks' selections cover every
    # block across the sequence), V, and the output, each once
    el = q.element_size()
    nbytes = el * (b * h * s * nsel + 2 * b * kvh * s * d + b * h * s * d)
    bms, by = bound(nbytes, ops, BF16_OPS_PER_S if el == 2
                    else F32_ACCURATE_OPS_PER_S)
    return dict(name="aqua_prefill", geometry=geom, form=form, dtype=dtype,
                route=attention_route(el),
                shape=dict(B=b, H=h, KV=kvh, S=s, D=d, q_blk=q_blk,
                           k_ratio=k_ratio, pad_rows=pad),
                **check, **timings(kernel, plain, library), bound_ms=bms,
                bound_by=by, device_us=device_us(kernel))


def prefill_chunk_phase(geom: str, h: int, kvh: int, gen) -> dict:
    """The prefill kernel's ``q_offset`` form, as chunked prefill runs it:
    the last 1024 of 4096 rows against all 4096 keys, held against its
    plain version and against the same rows of the monolithic call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import aqua
    from repro_torch.kernels import aqua_prefill as pk
    from repro_torch.kernels.ops import prefill_blocks, round_k_dims

    b, s, t, d, q_blk = 1, 4096, 1024, 128, 128
    off = s - t
    dev, bf = "cuda", torch.bfloat16
    q = torch.randn(b, h, s, d, device=dev, generator=gen).to(bf)
    k = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(bf)
    v = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(bf)
    lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    scale = d ** -0.5
    nsel = round_k_dims(d, K_RATIO, BLOCK_DIMS)
    qc = q[:, :, off:]
    block_idx, _, _ = prefill_blocks(qc, lengths - off, K_RATIO, BLOCK_DIMS,
                                     q_blk)
    kw = dict(block_dims=BLOCK_DIMS, q_blk=q_blk, causal=True, scale=scale)

    def kernel(q_offset=off):
        return pk.aqua_prefill_attention(qc, k, v, block_idx, lengths,
                                         q_offset=q_offset, **kw)

    def plain():
        return pk.aqua_prefill_plain(qc, k, v, block_idx, lengths,
                                     q_offset=off, **kw)

    out = kernel()
    check = check_kernel(out, plain(), {
        "q_offset_one_q_blk_early": kernel(q_offset=off - q_blk)})
    full_idx = aqua.chunk_topk_block_indices(q, nsel, BLOCK_DIMS, q_blk,
                                             lengths).contiguous()
    mono = pk.aqua_prefill_attention(q, k, v, full_idx, lengths,
                                     **kw)[:, :, off:]
    vs_mono = tol_ratio(out, mono)
    check["ok"] = check["ok"] and vs_mono <= 1.0
    sel = torch.zeros(b, h, t // q_blk, d // BLOCK_DIMS, device=dev)
    sel.scatter_(-1, block_idx.long(), 1.0)
    qm = qc * sel.repeat_interleave(BLOCK_DIMS, -1).repeat_interleave(
        q_blk, 2).to(bf)
    qpos = off + torch.arange(t, device=dev)
    mask = qpos[:, None] >= torch.arange(s, device=dev)[None, :]

    def library():
        return F.scaled_dot_product_attention(qm, k, v, attn_mask=mask,
                                              scale=scale, enable_gqa=True)

    pairs = t * off + t * (t + 1) / 2
    ops = 2 * pairs * h * (nsel + d)
    nbytes = 2 * (b * h * t * nsel + 2 * b * kvh * s * d + b * h * t * d)
    bms, by = bound(nbytes, ops)
    return dict(name="aqua_prefill", geometry=geom, form="q_offset",
                shape=dict(B=b, H=h, KV=kvh, S=s, T=t, q_offset=off, D=d,
                           q_blk=q_blk),
                **check, vs_monolithic_tol_ratio=vs_mono,
                bitwise_equal_to_monolithic=bool(torch.equal(out, mono)),
                selection_equal_to_monolithic=bool(torch.equal(
                    full_idx[:, :, off // q_blk:], block_idx)),
                **timings(kernel, plain, library), bound_ms=bms, bound_by=by)


def prefill_part_phase(geom: str, h: int, kvh: int, gen) -> dict:
    """The participating-chunk prefill (``_part_kernel``): each q-tile
    walks 8 of the 32 key chunks, chosen by ``chunk_participating_tiles``
    from seeded random scores (the diagonal pinned). Served nowhere, as in
    the JAX package: its launches are this phase's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import aqua, selection
    from repro_torch.kernels import aqua_prefill as pk
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.kernels.ops import round_k_dims

    b, s, d, blk, kept = 1, 4096, 128, 128, 8
    nc = s // blk
    dev, bf = "cuda", torch.bfloat16
    q = torch.randn(b, h, s, d, device=dev, generator=gen).to(bf)
    k = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(bf)
    v = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(bf)
    lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    scale = d ** -0.5
    nsel = round_k_dims(d, K_RATIO, BLOCK_DIMS)
    block_idx = aqua.chunk_topk_block_indices(q, nsel, BLOCK_DIMS, blk,
                                              lengths).contiguous()
    table = selection.chunk_participating_tiles(
        torch.rand(b, nc, device=dev, generator=gen), nqc=nc, q_blk=blk,
        k_blk=blk, kept_tiles=kept, pin_tiles=1).contiguous()
    kw = dict(block_dims=BLOCK_DIMS, q_blk=blk, causal=True, scale=scale,
              k_blk=blk)

    def kernel(kc_part=table, window=None):
        return pk.aqua_prefill_attention(q, k, v, block_idx, lengths,
                                         kc_part=kc_part, window=window,
                                         **kw)

    def plain():
        return pk.aqua_prefill_plain(q, k, v, block_idx, lengths,
                                     kc_part=table, **kw)

    # fault: the last q-tile swaps its first kept chunk for a dropped one
    bad = table.clone()
    dropped = [c for c in range(nc) if c not in set(table[0, -1].tolist())]
    bad[0, -1, 0] = dropped[0]
    bad = torch.sort(bad, dim=-1)[0].contiguous()
    before = LAUNCHES["aqua_prefill_part"]
    check = check_kernel(kernel(), plain(), {"swapped_chunk": kernel(bad)})
    ident = torch.arange(nc, dtype=torch.int32, device=dev).expand(
        b, nc, nc).contiguous()
    walk = kernel(ident)
    launches = LAUNCHES["aqua_prefill_part"] - before
    dense = pk.aqua_prefill_attention(q, k, v, block_idx, lengths,
                                      **{x: y for x, y in kw.items()
                                         if x != "k_blk"})
    vs_dense = tol_ratio(walk, dense)
    check["ok"] = check["ok"] and vs_dense <= 1.0
    # the keys each row attends: its q-tile's chunks, causal
    part = torch.zeros(nc, nc, dtype=torch.bool, device=dev)
    part.scatter_(-1, table[0].long(), True)
    pos = torch.arange(s, device=dev)
    mask = part[pos // blk][:, pos // blk] & (pos[:, None] >= pos[None, :])
    sel = torch.zeros(b, h, nc, d // BLOCK_DIMS, device=dev)
    sel.scatter_(-1, block_idx.long(), 1.0)
    qm = q * sel.repeat_interleave(BLOCK_DIMS, -1).repeat_interleave(
        blk, 2).to(bf)

    def library():
        return F.scaled_dot_product_attention(qm, k, v, attn_mask=mask,
                                              scale=scale, enable_gqa=True)

    # the walk under a window: each q-tile's chunks, cut to its band
    win = 1024
    wcheck = check_kernel(
        kernel(window=win),
        pk.aqua_prefill_plain(q, k, v, block_idx, lengths, kc_part=table,
                              window=win, **kw),
        {"window_off_by_one": kernel(window=win + 1)})
    check["ok"] = check["ok"] and wcheck["ok"]
    pairs = float(mask.sum())
    ops = 2 * pairs * h * (nsel + d)
    chunks_read = int(part.any(dim=0).sum())
    nbytes = 2 * (b * h * s * nsel + 2 * b * kvh * chunks_read * blk * d
                  + b * h * s * d) + 4 * table.numel()
    bms, by = bound(nbytes, ops)
    return dict(name="aqua_prefill_part", geometry=geom,
                shape=dict(B=b, H=h, KV=kvh, S=s, D=d, q_blk=blk, k_blk=blk,
                           kept_tiles=kept, key_chunks=nc),
                **check, window_case=dict(window=win, **wcheck),
                identity_vs_dense_tol_ratio=vs_dense,
                identity_bitwise_equal_to_dense=bool(torch.equal(walk,
                                                                 dense)),
                live_pair_share=pairs / (s * (s + 1) / 2),
                phase_launches=launches,
                **timings(kernel, plain, library, plain_iters=5),
                bound_ms=bms, bound_by=by)


def sdpa_causal_ms(q, k, v, scale: float) -> dict:
    """A second yardstick for a no-window form: one causal SDPA call
    without a mask on the same q, k and v, K and V copied out to every
    query head beforehand. bf16 is held to PyTorch's flash backend (which
    takes head dims up to 256), float32 to the backend SDPA picks."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = q.shape[1] // k.shape[1]
    k, v = (x.repeat_interleave(g, 1).contiguous() for x in (k, v))
    flash = q.dtype == torch.bfloat16

    def call():
        if not flash:
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  scale=scale)
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  scale=scale)
    return dict(sdpa_causal_ms=graph_ms(call),
                sdpa_causal_backend="flash" if flash else "default")


def prefill_window_phase(geom: str, h: int, kvh: int, d: int, gen,
                         s: int = 8192, window: int = 4096,
                         heads: bool = False,
                         dtype: str = "bfloat16") -> dict:
    """The window form of the prefill kernel at a sliding-window model's
    geometry (H2O-Danube-1.8B: head_dim 80, window 4096, S=8192;
    RecurrentGemma-9B: 16 heads over one KV head of 256 dims, window 2048,
    S=4096, the engine's wide kernels, in bf16 or float32), B=1, causal,
    beside the no-window form on the same inputs (the tiles the band
    skips) and, at head_dim 256, beside one causal SDPA call without a
    mask (:func:`sdpa_causal_ms`). Planted faults: the window one key
    wider, and the band starting one key tile late (the participating
    walk over each q-tile's band minus its first 64-key tile: the same
    kernel with that tile skipped); with ``heads`` also the phase's head
    fault (:func:`head_fault`)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import aqua
    from repro_torch.kernels import aqua_prefill as pk
    from repro_torch.kernels.ops import round_k_dims

    b, q_blk, tile = 1, 128, pk.KEY_TILE
    dev, bf = "cuda", getattr(torch, dtype)
    q = torch.randn(b, h, s, d, device=dev, generator=gen).to(bf)
    k = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(bf)
    v = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(bf)
    lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    scale = d ** -0.5
    nsel = round_k_dims(d, K_RATIO, BLOCK_DIMS)
    block_idx = aqua.chunk_topk_block_indices(q, nsel, BLOCK_DIMS, q_blk,
                                              lengths).contiguous()
    kw = dict(block_dims=BLOCK_DIMS, q_blk=q_blk, causal=True, scale=scale)

    def kernel(window=window, q=q, block_idx=block_idx, **extra):
        return pk.aqua_prefill_attention(q, k, v, block_idx, lengths,
                                         window=window, **kw, **extra)

    def plain():
        return pk.aqua_prefill_plain(q, k, v, block_idx, lengths,
                                     window=window, **kw)

    # band one tile late: q-tile i's 64-key tiles from its band's first
    # tile + 1 to its diagonal, as a participation table of 64-key chunks
    nqc, nkc = s // q_blk, s // tile
    first = (torch.arange(nqc, device=dev) * q_blk - window + 1).clamp(
        min=0) // tile
    last = ((torch.arange(nqc, device=dev) + 1) * q_blk - 1) // tile
    c = torch.arange(nkc, device=dev)[None, :]
    keep = (c > first[:, None]) & (c <= last[:, None])
    late = torch.where(keep, c.expand(nqc, -1), torch.full_like(
        c.expand(nqc, -1), nkc))
    late = torch.sort(late, dim=-1)[0]
    late = torch.where(late == nkc, torch.full_like(late, -1), late)[
        None, :, :int(keep.sum(-1).max())].to(torch.int32).contiguous()
    faults = {"window_off_by_one": kernel(window=window + 1),
              "band_starts_one_tile_late": kernel(kc_part=late, k_blk=tile)}
    if heads:
        faults.update(head_fault(kernel, q, block_idx, kvh))
    check = check_kernel(kernel(), plain(), faults)
    sel = torch.zeros(b, h, nqc, d // BLOCK_DIMS, device=dev)
    sel.scatter_(-1, block_idx.long(), 1.0)
    qm = q * sel.repeat_interleave(BLOCK_DIMS, -1).repeat_interleave(
        q_blk, 2).to(bf)
    pos = torch.arange(s, device=dev)
    band = (pos[:, None] >= pos[None, :]) & \
        (pos[None, :] > pos[:, None] - window)

    def library():
        return F.scaled_dot_product_attention(qm, k, v, attn_mask=band,
                                              scale=scale, enable_gqa=True)

    # the live (query, key) pairs of the band
    pairs = float(sum(min(i + 1, window) for i in range(s)))
    ops = 2 * pairs * h * (nsel + d)
    el = q.element_size()
    nbytes = el * (b * h * s * nsel + 2 * b * kvh * s * d + b * h * s * d)
    bms, by = bound(nbytes, ops, BF16_OPS_PER_S if el == 2
                    else F32_ACCURATE_OPS_PER_S)
    times = timings(kernel, plain, library, plain_iters=3)
    no_window_ms = graph_ms(lambda: kernel(window=None))
    extra = sdpa_causal_ms(qm, k, v, scale) if d > 128 else {}
    return dict(name="aqua_prefill", geometry=geom, form="window",
                dtype=dtype, route=attention_route(el),
                value_slices=-(-d // 128) if el == 2 else 1,
                shape=dict(B=b, H=h, KV=kvh, S=s, D=d, Dv=d, q_blk=q_blk,
                           window=window),
                **check, **times, no_window_ms=no_window_ms, **extra,
                device_us=device_us(kernel),
                live_pair_share=pairs / (s * (s + 1) / 2), bound_ms=bms,
                bound_by=by, peak_bytes=torch.cuda.max_memory_allocated())


def empty_lane_phase(kernel: str, variant: str, dtype: str, gen,
                     s: int = 1024, pad: int = 21) -> dict:
    """A lane of length 0 beside a bucket-padded admission (B=2, lengths
    ``s - pad`` and 0): each row of the empty lane must be the mean of its
    V over all S keys (JAX's dense reference and the plain version), every
    row of both lanes held against the plain version at its dtype's
    limit; the planted fault is the kernels' earlier answer, zeros in the
    empty lane. ``variant`` "narrow": Qwen3-0.6B's geometry (head_dim 128;
    the prefill at K_RATIO, a 12-chunk union); "generic": the generic
    kernels' shapes (flash at H2O-Danube-1.8B's head_dim 80, the prefill
    at k_ratio 0.5, an 8-chunk union). Causal, q_blk 128."""
    import torch
    from repro_torch.kernels import aqua_prefill as pk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels.ops import prefill_blocks

    generic = variant == "generic"
    geom, h, kvh, d = (("h2o-danube-1.8b", 32, 8, 80)
                       if generic and kernel == "flash_attention"
                       else ("qwen3-0.6b", 16, 8, 128))
    b, dev, dt = 2, "cuda", getattr(torch, dtype)
    q = torch.randn(b, h, s, d, device=dev, generator=gen).to(dt)
    k = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(dt)
    v = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(dt)
    lengths = torch.tensor([s - pad, 0], dtype=torch.int32, device=dev)
    shape = dict(B=b, H=h, KV=kvh, S=s, D=d, lengths=[s - pad, 0])
    if kernel == "flash_attention":
        out = fk.flash_attention(q, k, v, causal=True, lengths=lengths)
        ref = fk.flash_attention_plain(q, k, v, causal=True,
                                       lengths=lengths)
    else:
        k_ratio = 0.5 if generic else K_RATIO
        block_idx, _, q_blk = prefill_blocks(q, lengths, k_ratio,
                                             BLOCK_DIMS, 128)
        kw = dict(block_dims=BLOCK_DIMS, q_blk=q_blk, causal=True,
                  scale=d ** -0.5)
        out = pk.aqua_prefill_attention(q, k, v, block_idx, lengths, **kw)
        ref = pk.aqua_prefill_plain(q, k, v, block_idx, lengths, **kw)
        shape["k_ratio"] = k_ratio
    zeros = out.clone()
    zeros[1] = 0
    mean = v[1].float().mean(1).repeat_interleave(h // kvh, 0)[:, None]
    return dict(name=kernel, geometry=geom, form="empty_lane",
                variant=variant, dtype=dtype, route=attention_route(
                    q.element_size()), shape=shape,
                mean_of_v_err=(out[1].float() - mean).abs().max().item(),
                **check_kernel(out, ref, {"zeros_in_empty_lane": zeros}))


def flash_phase(geom: str, h: int, kvh: int, gen, s: int = 2048,
                form: str = None, d: int = 128,
                dtype: str = "bfloat16", pad: int = 0) -> dict:
    """Flash attention, B=1, causal, over ``s`` rows of head_dim ``d``;
    the served form (``form="served"``) at the drives' longest prompt.
    bf16 runs on ``wgmma``; float32 (``dtype``, the served checkpoint's)
    on ``wgmma`` in three TF32 passes. ``pad`` > 0: a bucket-padded
    admission's call, keys past ``s - pad`` masked by ``lengths``, every
    row held (pad rows see every valid key, as JAX's dense reference)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fk

    b = 1
    dev, bf = "cuda", getattr(torch, dtype)
    q = torch.randn(b, h, s, d, device=dev, generator=gen).to(bf)
    k = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(bf)
    v = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(bf)

    lengths = (torch.full((b,), s - pad, dtype=torch.int32, device=dev)
               if pad else None)

    def kernel(k=k, v=v, window=None, lengths=lengths):
        return fk.flash_attention(q, k, v, causal=True, window=window,
                                  lengths=lengths)

    def plain():
        return fk.flash_attention_plain(q, k, v, causal=True,
                                        lengths=lengths)

    # faults: rows past s/2 lose their far keys; every row sees one key
    # further (the diagonal shifted by one, key 0 lost)
    faults = {"window_cut": kernel(window=s // 2),
              "shifted_diagonal": kernel(k=torch.roll(k, -1, 2),
                                         v=torch.roll(v, -1, 2))}
    if pad:
        # the pad rows see the pad keys
        faults["lengths_ignored"] = kernel(lengths=None)
    check = check_kernel(kernel(), plain(), faults)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    ops = 2 * s * (s + 1) / 2 * h * (d + d)
    el = q.element_size()
    nbytes = el * (2 * b * h * s * d + 2 * b * kvh * s * d)
    bms, by = bound(nbytes, ops, BF16_OPS_PER_S if el == 2
                    else F32_ACCURATE_OPS_PER_S)
    return dict(name="flash_attention", geometry=geom, form=form,
                dtype=dtype, route=attention_route(el),
                shape=dict(B=b, H=h, KV=kvh, S=s, D=d, causal=True,
                           pad_rows=pad),
                **check, **timings(kernel, plain, library), bound_ms=bms,
                bound_by=by, device_us=device_us(kernel))


def flash_window_phase(geom: str, h: int, kvh: int, d: int, gen,
                       s: int = 4096, window: int = 2048,
                       dtype: str = "bfloat16") -> dict:
    """Flash attention's window form at a sliding-window model's geometry
    (RecurrentGemma-9B with AQUA off: 16 heads over one KV head of 256
    dims, window 2048: the engine's wide kernels, in bf16 or float32),
    B=1, S=4096, causal, beside the no-window form on the same inputs and
    one causal SDPA call without a mask (:func:`sdpa_causal_ms`). Planted
    faults: the window one key wider, the band starting one 64-key tile
    late (a window 64 keys shorter) and the phase's head fault
    (:func:`head_fault`)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fk

    b = 1
    dev, bf = "cuda", getattr(torch, dtype)
    q = torch.randn(b, h, s, d, device=dev, generator=gen).to(bf)
    k = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(bf)
    v = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(bf)

    def kernel(q=q, window=window):
        return fk.flash_attention(q, k, v, causal=True, window=window)

    def plain():
        return fk.flash_attention_plain(q, k, v, causal=True, window=window)

    faults = {"window_off_by_one": kernel(window=window + 1),
              "band_starts_one_tile_late": kernel(window=window - 64)}
    faults.update(head_fault(kernel, q, None, kvh))
    check = check_kernel(kernel(), plain(), faults)
    pos = torch.arange(s, device=dev)
    band = (pos[:, None] >= pos[None, :]) & \
        (pos[None, :] > pos[:, None] - window)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                              enable_gqa=True)

    pairs = float(sum(min(i + 1, window) for i in range(s)))
    ops = 2 * pairs * h * (d + d)
    el = q.element_size()
    nbytes = el * (2 * b * h * s * d + 2 * b * kvh * s * d)
    bms, by = bound(nbytes, ops, BF16_OPS_PER_S if el == 2
                    else F32_ACCURATE_OPS_PER_S)
    times = timings(kernel, plain, library, plain_iters=3)
    no_window_ms = graph_ms(lambda: kernel(window=None))
    return dict(name="flash_attention", geometry=geom, form="window",
                dtype=dtype, route=attention_route(el),
                value_slices=-(-d // 128) if el == 2 else 1,
                shape=dict(B=b, H=h, KV=kvh, S=s, D=d, causal=True,
                           window=window),
                **check, **times, no_window_ms=no_window_ms,
                **sdpa_causal_ms(q, k, v, d ** -0.5),
                device_us=device_us(kernel),
                live_pair_share=pairs / (s * (s + 1) / 2), bound_ms=bms,
                bound_by=by)


def paged_variant_phase(geom: str, h: int, kvh: int, quant: bool,
                        part: bool, gen, s: int = 4096, len_range=None,
                        form: str = None, b: int = 8,
                        granularity: str = "page_head") -> dict:
    """The paged decode over int8 pools (``quant``) and/or over the
    participating pages of hierarchical AQUA (``part``), B=``b`` (8) over a
    table of ``s`` positions, lengths uniform in ``len_range`` (default:
    s/2 to s); the served form (``form="served"``) takes the drives'
    contexts, where lanes shorter than the kept pages walk pages past their
    tail (lane 0 then takes the longest context, so that it drops pages for
    the planted page swap). int8 scales per page and KV head
    (``granularity`` "page_head") or one per page ("page")."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import SparsitySpec
    from repro_torch.core import aqua, selection
    from repro_torch.kernels import aqua_decode as dk
    from repro_torch.kernels.ops import round_k_dims

    d, ps = 128, 64
    npl = s // ps
    lo, hi = len_range or (s // 2, s)
    dev, bf = "cuda", torch.bfloat16
    q = torch.randn(b, h, d, device=dev, generator=gen).to(bf)
    k = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(bf)
    v = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(bf)
    lengths = torch.randint(lo, hi + 1, (b,), device=dev, generator=gen,
                            dtype=torch.int32)
    if form == "served":
        lengths[0] = hi
    scale = d ** -0.5
    nsel = round_k_dims(d, K_RATIO, BLOCK_DIMS)
    block_idx = aqua.topk_block_indices(q, nsel, BLOCK_DIMS).contiguous()
    table = torch.randperm(b * npl, device=dev, generator=gen).reshape(
        b, npl).to(torch.int32)

    def to_pool(x):            # (B, KV, S, D) -> (P, KV, ps, D) via table
        pool = torch.empty(b * npl, kvh, ps, d, device=dev, dtype=x.dtype)
        pool[table.long()] = x.reshape(b, kvh, npl, ps, d).transpose(1, 2)
        return pool
    k_pool, v_pool = to_pool(k), to_pool(v)
    scales = dict(k_scale=None, v_scale=None)
    if quant:                  # per-(page, kv head) or per-page int8
        for name, pool in (("k", k_pool), ("v", v_pool)):
            sc = pool.float().abs().amax(dim=(2, 3)) / 127.0    # (P, KV)
            if granularity == "page":
                sc = sc.amax(dim=1, keepdim=True)               # (P, 1)
            q8 = torch.round(pool.float() / sc[:, :, None, None]).clamp(
                -127, 127).to(torch.int8)
            scales[name + "_scale"] = sc.contiguous()
            if name == "k":
                k_pool = q8
            else:
                v_pool = q8
    part_idx = None
    if part:                   # the served rule: no statistics, sink + tail
        kp = SparsitySpec(page_keep_ratio=0.25).kept_pages(npl)
        part_idx = selection.participating_pages(
            torch.zeros(b * npl, kvh, ps, device=dev), table, lengths,
            page_size=ps, kept_pages=kp, pin_recent_pages=2).contiguous()

    def kernel(part_idx=part_idx, q=q, block_idx=block_idx, **kw):
        return dk.aqua_paged_decode_attention(
            q, k_pool, v_pool, block_idx, table, lengths,
            block_dims=BLOCK_DIMS, scale=scale, part_idx=part_idx,
            **{**scales, **kw})

    def plain():
        return dk.aqua_decode_plain(q, k_pool, v_pool, block_idx, lengths,
                                    table, block_dims=BLOCK_DIMS, scale=scale,
                                    part_idx=part_idx, **scales)

    faults = {"heads_past_group": heads_past_group(kernel, q, block_idx)}
    if quant:                  # lane 0's tail page (always attended)
        tail = table[0, (int(lengths[0]) - 1) // ps].long()
        for name in ("k_scale", "v_scale"):
            bad = scales[name].clone()
            bad[tail] *= 2
            faults["doubled_" + name] = kernel(**{name: bad})
    if part:                   # lane 0 keeps page 0 -> a dropped page
        bad = part_idx.clone()
        dropped = [p for p in range((int(lengths[0]) - 1) // ps)
                   if p not in set(part_idx[0].tolist())][0]
        bad[0, 0] = dropped
        faults["swapped_page"] = kernel(part_idx=torch.sort(bad)[0]
                                        .contiguous())
    check = check_kernel(kernel(), plain(), faults)

    # the positions this run attends: below each length, in the
    # participating pages
    pos = torch.arange(s, device=dev)
    valid = pos[None, :] < lengths[:, None]
    if part:
        valid &= selection.participation_slot_mask(part_idx, page_size=ps,
                                                   num_slots=s)
    # yardstick: one library call on the same attention over the
    # contiguous (dequantized) view, masked-q̂ and masked positions
    kc = (k_pool[table.long()].float() if not quant else
          k_pool[table.long()].float()
          * scales["k_scale"][table.long()][..., :, None, None])
    vc = (v_pool[table.long()].float() if not quant else
          v_pool[table.long()].float()
          * scales["v_scale"][table.long()][..., :, None, None])
    kc = kc.transpose(1, 2).reshape(b, kvh, s, d).to(bf)
    vc = vc.transpose(1, 2).reshape(b, kvh, s, d).to(bf)
    sel = torch.zeros(b, h, d // BLOCK_DIMS, device=dev)
    sel.scatter_(-1, block_idx.long(), 1.0)
    qm = (q * sel.repeat_interleave(BLOCK_DIMS, -1).to(bf))[:, :, None]

    def library():
        return F.scaled_dot_product_attention(
            qm, kc, vc, attn_mask=valid[:, None, None, :], scale=scale,
            enable_gqa=True)

    # bytes: per (lane, kv head) the union of its G heads' dim-blocks over
    # the attended rows, plus those V rows (1 byte each for int8), q, the
    # output, the selection, table, part and scale entries read
    g = h // kvh
    union = sel.reshape(b, kvh, g, -1).amax(dim=2).sum(dim=-1)   # (B, KV)
    rows = valid.sum(dim=1).double()                             # (B,)
    elem = 1 if quant else 2
    nbytes = elem * float((rows[:, None] * (union * BLOCK_DIMS + d)).sum())
    nbytes += 2 * q.numel() + (4 if quant else 2) * b * h * d
    nbytes += 4 * (block_idx.numel() + b + table.numel())
    if part:
        nbytes += 4 * part_idx.numel()
    if quant:
        pages_read = -(-rows // ps)
        nbytes += 2 * 4 * scales["k_scale"].shape[1] * float(
            pages_read.sum())
    ops = 2 * float(rows.sum()) * h * (nsel + d)
    bms, by = bound(nbytes, ops)
    route = dk.decode_route(bf, quant=quant, part=part, d=d, dv=d,
                            nsel=nsel)
    read = None
    if route == "group" and quant:
        # what the int8 group route reads (over every page or only the
        # participating ones): whole K̂ rows of the attended positions, not
        # the union
        read = nbytes + float((rows[:, None] * (d - union * BLOCK_DIMS)).sum())
    times = timings(kernel, plain, library)
    times["device_us"] = device_us(kernel)
    return dict(name=dk.body_name(True, quant, part), geometry=geom,
                form=form, route=route,
                shape=dict(B=b, H=h, KV=kvh, S=s, D=d, page_size=ps,
                           lengths=[lo, hi],
                           kept_pages=None if part_idx is None
                           else part_idx.shape[1],
                           kv_dtype="int8" if quant else "bf16",
                           scale_granularity=granularity if quant
                           else None),
                **check, **times, bound_ms=bms, bound_by=by,
                read_bytes=read, **byte_rate(nbytes, times["ms"]))


# ---------------------------------------------------------------------------
# Serving phase
# ---------------------------------------------------------------------------


# every kernel body of the port, by the name its launches count under
KERNELS = ("aqua_decode", "aqua_paged_decode", "aqua_paged_quant_decode",
           "aqua_paged_part_decode", "aqua_paged_part_quant_decode",
           "aqua_prefill", "aqua_prefill_part", "flash_attention")


def launch_counts() -> dict:
    from repro_torch.kernels._build import LAUNCHES
    return {name: LAUNCHES[name] for name in KERNELS}


def reset_counts() -> None:
    from repro_torch.kernels._build import LAUNCHES
    LAUNCHES.clear()


def kept_positions(eng):
    """(L, B, S) the positions each layer's cache holds per lane after the
    latest step, sorted (a paged state's logical slots; a hybrid's
    attention layers' rings)."""
    import torch
    from repro_torch.core import kvcache as kv
    layers = eng.last_state.layers
    if isinstance(layers, kv.HybridCache):
        layers = layers.attn
    if not isinstance(layers, kv.PagedAttnCache):
        return torch.sort(layers.positions, dim=-1)[0]
    return torch.stack([torch.sort(kv.gather_positions(layers.layer(i)),
                                   dim=-1)[0]
                        for i in range(layers.page_table.shape[0])])


def state_tensors(layers) -> dict:
    """A decode state's cache tensors by field name (a hybrid's nested
    stacks as "attn.k", "rec.state", ...)."""
    out = {}
    for f in dataclasses.fields(layers):
        t = getattr(layers, f.name)
        if dataclasses.is_dataclass(t):
            out.update({f"{f.name}.{k}": v
                        for k, v in state_tensors(t).items()})
        elif t is not None:
            out[f.name] = t
    return out


def clone_layers(layers):
    """A cache dataclass with every tensor cloned (nested stacks too)."""
    return type(layers)(**{
        f.name: (clone_layers(t) if dataclasses.is_dataclass(t)
                 else None if t is None else t.clone())
        for f in dataclasses.fields(layers)
        for t in (getattr(layers, f.name),)})


def serve_drive(eng, reqs, positions: bool = False, tape=None,
                gather=None) -> dict:
    """Serve ``reqs``; returns tokens per uid, each admission's logits, the
    logits of the first decode steps with each lane's uid and the tokens
    it held at that step (with ``positions``, also the positions every
    layer's cache held: H2O evicts by score), and wall-clock figures (the
    host reads every sampled token, so each step's time includes its
    device work). Every admission's and every decode step's logits must
    be finite. An engine with hot residents also reports the resident
    slots whose page changed, read at each admission's first token
    (``resident_promotions_seen``; admissions between two reads count
    once per slot), and the residents held at the end, per layer. With an
    MoE routing ``tape`` (``models.moe.RoutingTape``, installed), each
    admission's and each checked step's routing, every layer's, and the
    routing choices every admission and every step kept and dropped.
    ``gather``: applied to each checked step's logits (a mesh rank's own
    lanes, all-gathered over the data axes into every lane's)."""
    import torch
    from repro_torch.models import moe
    tokens, admit_logits, steps, admit_routes = {}, {}, [], {}
    totals = dict(admission_kept=0, admission_dropped=0, decode_kept=0,
                  decode_dropped=0)
    hot = eng.hot_pages > 0
    promotions, seen = 0, None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ev in eng.serve(reqs):
        if ev.index == 0:               # an admission: its prefill logits
            logits = eng.last_admit_logits
            assert torch.isfinite(logits).all(), f"request {ev.uid}"
            admit_logits[ev.uid] = logits.float().clone()
            if tape is not None:
                admit_routes[ev.uid] = tape.latest(decode=False)
                kept, dropped = moe.kept_counts(admit_routes[ev.uid][1])
                totals["admission_kept"] += kept
                totals["admission_dropped"] += dropped
            if hot:
                ids = eng.last_state.layers.hot_ids.cpu()
                if seen is not None:
                    promotions += int(((ids != seen) & (ids >= 0))[0].sum())
                else:
                    promotions += int((ids >= 0)[0].sum())
                seen = ids
        elif eng.stats.decode_steps > len(steps):
            # the first event of a new decode step: ``tokens`` still holds
            # what each lane had fed in
            logits = eng.last_step_logits
            if gather is not None:
                logits = gather(logits)
            assert torch.isfinite(logits).all(), \
                f"decode step {eng.stats.decode_steps}"
            routes = None if tape is None else tape.latest(decode=True)
            if routes is not None:
                kept, dropped = moe.kept_counts(routes[1])
                totals["decode_kept"] += kept
                totals["decode_dropped"] += dropped
            if len(steps) < DECODE_STEPS_CHECKED:
                uids = [int(u) for u in eng.last_lanes.uid]
                steps.append(dict(logits=logits.float().clone(), uids=uids,
                                  held={u: tuple(tokens[u]) for u in uids
                                        if u in tokens},
                                  positions=kept_positions(eng)
                                  if positions else None, routes=routes))
            else:
                steps.append(None)
        tokens.setdefault(ev.uid, []).append(ev.token)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats
    return dict(tokens=tokens, admit_logits=admit_logits,
                admit_routes=admit_routes,
                route_totals=totals if tape is not None else None,
                step_logits=[x for x in steps if x is not None], wall_s=wall,
                tokens_emitted=st.tokens_emitted,
                tokens_per_s=st.tokens_emitted / wall,
                decode_steps=st.decode_steps,
                decode_step_ms=1e3 * st.decode_seconds / max(st.decode_steps,
                                                             1),
                admissions=st.admissions,
                chunked_admissions=st.chunked_admissions,
                prefill_chunks=st.prefill_chunks,
                admit_ms=1e3 * st.admit_seconds / max(st.admissions, 1),
                itl_p50_ms=1e3 * st.itl_percentile(50),
                itl_p99_ms=1e3 * st.itl_percentile(99),
                max_itl_ms=1e3 * st.max_itl,
                mean_occupancy=st.mean_occupancy,
                **(dict(hot_pages=eng.hot_pages,
                        resident_promotions_seen=promotions,
                        residents_at_end=(eng.last_state.layers.hot_ids >= 0)
                        .sum(dim=-1).tolist()) if hot else {}))


def compare_logits(run: dict, ref: dict, max_new: int,
                   per_element: bool = False, scale: float = 1.0,
                   check: bool = True, routed: bool = None,
                   by_uid: bool = False, selections=None) -> dict:
    """Logits of the kernel drive against the plain drive of the same
    trace: every admission (same prompt), and in each checked decode step
    every lane that was still generating and held the same tokens in both
    drives — and, where the drives recorded them (H2O), the same kept
    positions in every layer: the two drives' hidden states differ by
    bf16 noise, so near-tied scores may evict differently. Each row must
    stay within LOGIT_RTOL of its largest magnitude (bf16), or with
    ``per_element`` (float32) every logit within ``scale`` times F32_RTOL
    of itself plus F32_ATOL; raises otherwise, unless ``check`` is off
    (a control drive's reading). Where the drives recorded MoE routing
    codes, only admissions whose every token (pad rows too) was routed
    alike in every layer are compared, and in decode only lanes whose
    admission and every checked step since were routed alike: a rounding
    difference can flip an expert at a near tie or a capacity drop; the
    rows this excluded are counted (``routed`` False compares every row,
    as against a drive that replayed the run's routing; with ``routed``
    True or False an empty comparison is reported, not refused).
    ``by_uid``: a decode row is matched to the reference's by its
    request, not its lane (a mesh engine fills its lanes in another
    order). ``selections``: both drives' dim-block selections of the
    checked decode steps (``decode_selections``): as with routing, a
    lane is compared only up to the step before its selection first
    differs from the reference's in some layer and head (a rounding
    difference can rank two near-tied dim-blocks of |q̂| the other way);
    the rows this excluded are counted, and each such lane's first step
    reported with the layers and (layer, head) pairs that differ."""
    import torch

    def row_check(got, want, what):
        if per_element:
            ratio = ((got - want).abs()
                     / (scale * (F32_RTOL * want.abs() + F32_ATOL))
                     ).max().item()
            assert ratio <= 1.0 or not check, \
                f"{what}: float32 logits off by {ratio} of the limit"
            return ratio
        err = (got - want).abs().max().item()
        limit = LOGIT_RTOL * want.abs().max().item()
        assert err <= limit or not check, \
            f"{what}: logits error {err} > {limit}"
        return err / limit
    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    need_rows = routed is None
    if routed is None:
        routed = bool(ref.get("admit_routes"))
    alike = {u: not routed or same(run["admit_routes"][u],
                                   ref["admit_routes"][u])
             for u in ref["admit_logits"]}
    worst_admit = max((row_check(run["admit_logits"][u], want, f"admit {u}")
                       for u, want in ref["admit_logits"].items()
                       if alike[u]), default=0.0)
    worst_step, rows, first_divergent = 0.0, 0, {}
    routed_apart = selected_apart = 0
    sel_apart = {}
    assert len(run["step_logits"]) == len(ref["step_logits"]) \
        == DECODE_STEPS_CHECKED
    for i, (got, want) in enumerate(zip(run["step_logits"],
                                        ref["step_logits"])):
        assert by_uid or got["uids"] == want["uids"], \
            (i, got["uids"], want["uids"])
        for lane, u in enumerate(want["uids"]):
            held = want["held"].get(u)
            if held is None or len(held) >= max_new \
                    or got["held"].get(u) != held:
                continue
            glane = got["uids"].index(u) if by_uid else lane
            if routed and alike.get(u, False) and not same(
                    [r[:, glane] for r in got["routes"]],
                    [r[:, lane] for r in want["routes"]]):
                alike[u] = False          # from this step on
            if not alike.get(u, True):
                routed_apart += 1
                continue
            if selections is not None and u not in sel_apart:
                differ = (selections[0][i][:, glane]
                          != selections[1][i][:, lane]).any(dim=-1)
                if bool(differ.any()):        # (layers, heads)
                    sel_apart[u] = dict(step=i + 1,
                                        layers=int(differ.any(-1).sum()),
                                        layer_heads=int(differ.sum()))
            if u in sel_apart:
                selected_apart += 1
                continue
            if want["positions"] is not None and not bool(
                    (got["positions"][:, glane]
                     == want["positions"][:, lane]).all()):
                first_divergent.setdefault(lane, i + 1)
                continue
            worst_step = max(worst_step, row_check(
                got["logits"][glane], want["logits"][lane],
                f"decode step {i + 1} lane {lane}"))
            rows += 1
    assert rows > 0 or not need_rows, "no decode-step logits were compared"
    pairs = [(a, b) for uid in ref["tokens"]
             for a, b in zip(run["tokens"][uid], ref["tokens"][uid])]
    out = {}
    if selections is not None:
        out = dict(decode_rows_selected_apart=selected_apart,
                   first_selection_apart_by_uid={
                       str(u): v for u, v in sel_apart.items()})
    if routed:
        out = dict(out, admissions_routed_apart=sum(
            not same(run["admit_routes"][u], ref["admit_routes"][u])
            for u in ref["admit_logits"]),
            decode_rows_routed_apart=routed_apart)
    return dict(**out, admissions_compared=len(ref["admit_logits"])
                - out.get("admissions_routed_apart", 0),
                admit_worst_err_over_limit=worst_admit,
                decode_rows_compared=rows,
                decode_worst_err_over_limit=worst_step,
                first_step_with_other_positions_by_lane=first_divergent,
                greedy_token_match=sum(a == b for a, b in pairs) / len(pairs),
                first_token_match=sum(
                    run["tokens"][u][0] == ref["tokens"][u][0]
                    for u in ref["tokens"]) / len(ref["tokens"]))


def profiled_drive(eng, reqs, body: str) -> dict:
    """Serve ``reqs`` under ``torch.profiler``: the device's busy share of
    the wall time and the kernels that take most of the device time. The
    engine's step graph is already captured, so every decode step is a
    replay: the trace is complete (``trace_complete``) only if it holds
    each launch of the decode kernel ``body`` that the drive counted (its
    partial and its combine pass); else the profiler missed kernels and
    ``idle_share`` is None (not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    assert eng.step_graph is not None
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in eng.serve(reqs):
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts()[body]
    by_name: dict = {}
    passes = {"decode_bf16": [0, 0.0], "aqua_decode_combine": [0, 0.0]}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0.0) + us * 1e-6
            for key, acc in passes.items():
                if key in e.name:
                    acc[0] += 1
                    acc[1] += us
    busy = sum(by_name.values())
    assert launches == eng.cfg.num_layers * eng.stats.decode_steps > 0
    # a trace short of a decode pass would understate the busy time: its
    # idle share is not measured (None), and the run says so
    complete = busy > 0 and all(n == launches for n, _ in passes.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(trace_complete=complete, wall_s=wall, device_busy_s=busy,
                idle_share=1 - busy / wall if complete else None,
                decode_steps=eng.stats.decode_steps,
                decode_step_ms=1e3 * eng.stats.decode_seconds
                / eng.stats.decode_steps,
                decode_launches=launches,
                traced_decode_passes={k: dict(events=n, device_us=us,
                                              us_per_call=us / n)
                                      for k, (n, us) in passes.items()},
                top_kernels=[dict(name=n[:80], s=t, share=t / busy)
                             for n, t in top])


_BITS = {"torch.float32": "int32", "torch.bfloat16": "int16"}


def bits(t):
    """``t``'s bits (floats viewed as integers of their width): equality
    of these is bitwise equality."""
    import torch
    name = _BITS.get(str(t.dtype))
    return t if name is None else t.view(getattr(torch, name))


def replay_skipping(graph, tokens, active, skip: str):
    """``StepGraph.replay`` with the host copy of ``skip`` ("tokens" or
    "write_mask") left out, so the graph reads that buffer as the previous
    step left it: a planted fault."""
    import torch
    if skip != "tokens":
        graph.tokens.copy_(torch.from_numpy(tokens))
    if skip != "write_mask":
        graph.write_mask.copy_(torch.from_numpy(active))
    graph.graph.replay()
    return graph.logits


def traced_replay(graph) -> dict:
    """One replay of a captured ``torch.cuda.CUDAGraph`` under
    ``torch.profiler``: the device operations it ran and their busy ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    nodes = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return dict(device_ops_per_replay=len(nodes),
                traced_replay_busy_ms=1e-3 * sum(
                    e.time_range.elapsed_us() for e in nodes))


def clone_extra(extra):
    """A ``DecodeState.extra`` with every tensor cloned."""
    import torch
    if isinstance(extra, torch.Tensor):
        return extra.clone()
    if isinstance(extra, dict):
        return {k: clone_extra(v) for k, v in extra.items()}
    return type(extra)(clone_extra(v) for v in extra)


def step_graph_phase(path: str, eng, reqs, steps: int = 16,
                     trace: bool = False, stale: tuple = ()) -> dict:
    """Admit the drive's prompts at once (at most one per lane), clone the
    state, and run ``steps`` decode steps with seeded tokens and write
    masks (each lane writes with probability 0.75) through the engine's
    step graph on the engine's state and through eager
    ``model.decode_step`` on the clone: logits of every step and every
    state tensor after the last must be equal bit for bit. The same
    replays skipping the copy of the tokens, or of the write mask, from
    the second step on must not be. Also the host ms of a step of each
    (up to the logits on the device, synchronized), the device ms of a
    replay alone (16 back to back between two CUDA events) and, with
    ``trace``, the kernels (and copies) one replay runs, from
    ``torch.profiler`` (``traced_replay``; the traced drive's child
    process traces the paged engine's). An encoder-decoder's state holds
    the lanes' cross K/V (``extra["cross"]``), which the eager twin gets
    a copy of: a third planted fault, the replays reading each lane's
    neighbour's cross K/V (rolled one lane on), must break the equality
    too. Each name in ``stale`` (a recurrent state tensor of
    :func:`state_tensors`: Mamba-2's "state", the hybrid's "rec.state")
    plants one more: that tensor put back after every replay to what it
    held before it, so each step reads the state the admission left (a
    step that did not write it in place)."""
    import numpy as np
    import torch
    reqs = [dataclasses.replace(r, arrival=0.0)
            for r in reqs][:eng.scfg.max_lanes]
    events = eng.serve(reqs)
    for _ in events:
        if eng.stats.admissions == len(reqs):
            break
    events.close()
    graph, state = eng.step_graph, eng.last_state
    layers = state.layers
    tensors = state_tensors(layers)
    snap = {k: t.clone() for k, t in tensors.items()}
    twin = dataclasses.replace(state, layers=clone_layers(layers),
                               extra=clone_extra(state.extra))
    rng = np.random.default_rng(0)
    lanes = eng.scfg.max_lanes
    inputs = [(rng.integers(0, eng.cfg.vocab_size, lanes).astype(np.int32),
               rng.random(lanes) < 0.75) for _ in range(steps)]
    assert any((a != inputs[0][1]).any() for _, a in inputs[1:])
    want = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for toks, act in inputs:
        lg, _ = eng.model.decode_step(
            eng.params, twin, torch.from_numpy(toks).cuda(),
            aqua_proj=eng.proj, write_mask=torch.from_numpy(act).cuda())
        want.append(lg.clone())
    torch.cuda.synchronize()
    eager_ms = 1e3 * (time.perf_counter() - t0) / steps
    want_state = state_tensors(twin.layers)

    def run(skip=None):
        """Replays from the admitted state: (logits equal in every step,
        state equal after the last, worst |logit difference|, ms a step)."""
        for k, t in tensors.items():
            t.copy_(snap[k])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = []
        for i, (toks, act) in enumerate(inputs):
            if skip in tensors:
                held = tensors[skip].clone()
                lg = graph.replay(toks, act)
                tensors[skip].copy_(held)     # the step's write lost
            else:
                lg = (graph.replay(toks, act) if skip is None or i == 0
                      else replay_skipping(graph, toks, act, skip))
            got.append(lg.clone())
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / steps
        logits_equal = all(torch.equal(bits(g), bits(w))
                           for g, w in zip(got, want))
        worst = max((g - w).abs().max().item() for g, w in zip(got, want))
        state_equal = all(torch.equal(bits(tensors[k]), bits(want_state[k]))
                          for k in tensors)
        return logits_equal, state_equal, worst, ms

    good = run()
    faults = {skip: run(skip) for skip in ("tokens", "write_mask")}
    for name in stale:
        faults[f"stale_{name}"] = run(name)
    if "cross" in state.extra:
        cross = state.extra["cross"]
        saved = [t.clone() for t in cross]
        for t, o in zip(cross, saved):
            t.copy_(o.roll(1, 1))             # each lane reads its neighbour's
        faults["other_lane_cross"] = run()
        for t, o in zip(cross, saved):
            t.copy_(o)
    # the device alone: replays back to back (the buffers hold the last
    # step's inputs)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        graph.graph.replay()
    end.record()
    torch.cuda.synchronize()
    out = dict(path=path, lanes_admitted=len(reqs), steps=steps,
               logits_bitwise=good[0], state_bitwise=good[1],
               max_abs_logit_diff=good[2], graph_step_ms=good[3],
               eager_step_ms=eager_ms,
               replay_device_ms=start.elapsed_time(end) / steps,
               **(traced_replay(graph.graph) if trace else {}),
               capture_ms=graph.capture_ms, pool_bytes=graph.pool_bytes,
               faults={k: dict(logits_bitwise=f[0], state_bitwise=f[1],
                               max_abs_logit_diff=f[2])
                       for k, f in faults.items()})
    assert good[0] and good[1], out
    assert all(not (f[0] and f[1]) for f in faults.values()), out
    return out


def admit_graph_phase(path: str, eng) -> dict:
    """After the drive's serve has captured one admission graph per prompt
    bucket: for each bucket, in the reverse of the capture order, two
    admissions (seeded prompts of two lengths in the bucket, two lanes,
    and on a paged pool two random page rows) replayed on the engine's
    state and run eagerly (``admit_graph.admission``, what the graphs
    capture) on a clone of it: the logits of every admission and every
    state tensor after it must be equal bit for bit. Two planted faults
    must break that equality: the second admission of each bucket
    replayed with the first's lane left in the graph's lane buffer, and
    with the first's length left in its lengths buffer. Also each bucket's
    capture ms and pool growth, the shared pool's bytes beside the step
    graph's, the host ms of an admission replayed and eager (to the
    logits on the device, synchronized), the device ms of the largest
    bucket's replay (16 back to back between two CUDA events). A VLM
    drive's admissions carry patches: its graphs are the frontend ones,
    each admission of the plan has its own patches, and a third planted
    fault, the second admission of each bucket replayed with the first's
    patches left in the graph's buffer, must break the equality too."""
    import numpy as np
    import torch
    from repro_torch.data.corpus import request_frontend_inputs
    from repro_torch.serving.admit_graph import admission
    frontend = bool(eng.frontend_admit_graphs)
    graphs = eng.frontend_admit_graphs if frontend else eng.admit_graphs
    captured = list(graphs)
    assert captured, path
    layers = eng.last_state.layers
    tensors = {f.name: getattr(layers, f.name)
               for f in dataclasses.fields(layers)
               if getattr(layers, f.name) is not None}
    snap = {k: t.clone() for k, t in tensors.items()}
    twin = dataclasses.replace(eng.last_state, layers=type(layers)(**{
        k: t.clone() for k, t in tensors.items()}),
        extra=clone_extra(eng.last_state.extra))
    rng = np.random.default_rng(1)
    lanes = eng.scfg.max_lanes
    plan = []
    for i, bucket in enumerate(captured[::-1]):
        for j in range(2):
            n = bucket - 1 - 37 * j
            row = None
            if eng.paged:
                need = -(-bucket // eng.cache_spec.page_size)
                row = np.full(eng.pages_per_lane, -1, np.int32)
                row[:need] = rng.permutation(eng.pool_geometry[0])[:need]
            plan.append((bucket, rng.integers(0, eng.cfg.vocab_size, n)
                         .astype(np.int32), (2 * i + j) % lanes, row,
                         request_frontend_inputs(eng.cfg, 1000 + len(plan))
                         if frontend else None))
    want, replay_ms, eager_ms = [], [], []
    logits_equal = state_equal = True
    for bucket, prompt, lane, row, extra in plan:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = graphs[bucket].admit(prompt, lane, row, extra).clone()
        torch.cuda.synchronize()
        replay_ms.append(1e3 * (time.perf_counter() - t0))
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :len(prompt)] = prompt
        t0 = time.perf_counter()
        lg = admission(eng.model, eng.params, twin, eng.proj,
                       eng.scfg.max_seq, torch.from_numpy(toks).cuda(),
                       torch.tensor([len(prompt)], dtype=torch.int32,
                                    device="cuda"),
                       torch.tensor([lane], device="cuda"),
                       None if row is None else torch.from_numpy(row).cuda(),
                       extra={k: torch.from_numpy(v).cuda()
                              for k, v in (extra or {}).items()})
        torch.cuda.synchronize()
        eager_ms.append(1e3 * (time.perf_counter() - t0))
        want.append(lg.clone())
        logits_equal &= torch.equal(bits(got), bits(lg))
        state_equal &= all(torch.equal(bits(t), bits(getattr(twin.layers,
                                                              k)))
                           for k, t in tensors.items())

    def faulty(stale: str):
        """The plan replayed from the served state with the second
        admission of each bucket reading ``stale`` ("lane", "lengths" or a
        frontend input's name) as the first left it: (logits equal in
        every admission, state equal after the last)."""
        for k, t in tensors.items():
            t.copy_(snap[k])
        got = []
        for j, (bucket, prompt, lane, row, extra) in enumerate(plan):
            graph = graphs[bucket]
            if j % 2 == 0:
                got.append(graph.admit(prompt, lane, row, extra).clone())
                continue
            buf = (graph.extra[stale] if stale in graph.extra
                   else getattr(graph, stale))
            old = buf.clone()
            graph.fill(prompt, lane, row, extra)
            buf.copy_(old)
            graph.graph.replay()
            got.append(graph.logits.clone())
        return (all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want)),
                all(torch.equal(bits(t), bits(getattr(twin.layers, k)))
                    for k, t in tensors.items()))
    faults = {stale: faulty(stale) for stale in
              ("lane", "lengths", *graphs[captured[0]].extra)}
    # the device alone: the largest bucket's replays back to back
    big = graphs[max(captured)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(16):
        big.graph.replay()
    end.record()
    torch.cuda.synchronize()
    acc = eng.graph_accounting()
    pre = "frontend_" if frontend else ""
    out = dict(path=path, buckets_capture_order=captured,
               replay_order=[p[0] for p in plan], admissions=len(plan),
               logits_bitwise=logits_equal, state_bitwise=state_equal,
               frontend_inputs=sorted(graphs[captured[0]].extra),
               admit_graphs=acc["admit_graphs"],
               capture_ms=acc[pre + "admit_capture_ms"],
               pool_growth_bytes=acc[pre + "admit_pool_growth_bytes"],
               shared_pool_bytes=acc["admit_pool_bytes"],
               step_graph_pool_bytes=acc["step_pool_bytes"],
               launches_per_admission=dict(big.launches),
               replay_host_ms=replay_ms, eager_host_ms=eager_ms,
               largest_bucket=max(captured),
               replay_device_ms=start.elapsed_time(end) / 16,
               faults={k: dict(logits_bitwise=f[0], state_bitwise=f[1])
                       for k, f in faults.items()})
    assert logits_equal and state_equal, out
    assert all(not (f[0] and f[1]) for f in faults.values()), out
    return out


TRACED_DRIVE_FLAG = "--traced-drive"
#: the common prompt prefix (tokens) of the drives that share one
SHARED_PREFIX = {"prefix_paged": 512}


def paged_serving():
    """The paged drives' serving configuration: 8 lanes, max_seq 2048, 32
    new tokens, 64-token pages, no prefix sharing."""
    from repro_torch.configs import CacheSpec, ServingConfig
    return ServingConfig(max_lanes=8, max_seq=2048, max_new_tokens=32,
                         cache=CacheSpec(page_size=64, prefix_sharing=False))


def drive_trace(n: int, vocab: int, prompts=(128, 512, 1024),
                shared_prefix: int = 0, mcfg=None, max_new: int = 32,
                interarrival: float = 4.0):
    """The drives' Poisson trace: ``n`` requests, ``max_new`` (32) new
    tokens each, ``interarrival`` (4) decode steps apart on average; with
    ``shared_prefix``, every prompt behind one random prefix of that many
    tokens (drawn as the launcher's ``--shared-prefix-len`` draws it).
    A model config ``mcfg`` with a frontend gives each request its own
    stub frontend inputs (``data.corpus.request_frontend_inputs``, by
    uid)."""
    import numpy as np
    from repro_torch.data.corpus import request_frontend_inputs
    from repro_torch.serving import poisson_trace
    reqs = poisson_trace(n, mean_interarrival=interarrival,
                         prompt_lens=prompts, max_new_tokens=max_new,
                         vocab_size=vocab, seed=0)
    pre = np.random.default_rng(1).integers(0, vocab, size=(shared_prefix,),
                                            dtype=np.int32)
    for r in reqs:
        r.tokens = np.concatenate([pre, np.asarray(r.tokens, np.int32)])
        if mcfg is not None:
            r.extra_inputs = request_frontend_inputs(mcfg, r.uid)
    return reqs


def run_drive(mcfg, mparams, mproj, serving, n, prompts=None,
              backend=None, shared_prefix=0, tape=None,
              selection=None) -> dict:
    """One drive of the Poisson trace (``drive_trace``) on a new engine,
    with the counters zeroed just before it and read just after it, and
    the peak device memory over it: the card's, and above what was
    allocated when it started (the weights). Every request must emit its
    32 tokens; an evicting engine's positions must pass its slots. An MoE
    drive records its routing on a ``models.moe.RoutingTape`` (its own, or
    ``tape`` = (tape, "record" or "replay"): a replay routes by another
    drive's recording) and counts its dropped routing choices.
    ``selection`` = (a ``core.aqua.SelectionTape``, "record" or
    "replay"): the drive's dim-block selections through that tape (kept
    in ``run["selection_tape"]``: the engine's graphs write it)."""
    import torch
    from repro_torch.models import moe
    from repro_torch.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(
        mcfg, mparams, None if mcfg.aqua is None else mproj,
        serving=serving, backend=backend)
    reqs = drive_trace(n, mcfg.vocab_size,
                       (128, 512, 1024) if prompts is None else prompts,
                       shared_prefix, mcfg)
    evicting = eng.eviction != "none"
    routed = mcfg.family == "moe"
    if routed:
        # the engine's graphs capture the tape's writes: it stays alive
        # with the engine (``run["tape"]``)
        tape, mode = tape or (moe.RoutingTape(
            mcfg, mparams["layers"]["ffn"]["router"], serving.max_lanes,
            serving.max_seq), "record")
        tape.install(mode)
    if selection is not None:
        selection[0].install(selection[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    reset_counts()
    try:
        run = serve_drive(eng, reqs, positions=evicting,
                          tape=tape if routed else None)
    finally:
        if routed:
            tape.remove()
        if selection is not None:
            selection[0].remove()
    if selection is not None:
        run["selection_tape"] = selection[0]
    run["launches"], run["engine"] = launch_counts(), eng
    if routed:
        run["tape"] = tape
        run["drops"] = routing_drops(run, reqs, mcfg)
    graph = eng.step_graph
    run["capture_ms"], run["graph_pool_bytes"] = (graph.capture_ms,
                                                  graph.pool_bytes)
    run["graphs"] = eng.graph_accounting()
    run["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    run["drive_peak_memory_bytes"] = run["peak_memory_bytes"] - start
    pool = eng.page_pool
    run["prefix_hits"] = 0 if pool is None else pool.prefix_hits
    run["tokens_saved"] = 0 if pool is None else pool.tokens_saved
    run["peak_pages_in_use"] = None if pool is None else pool.peak_in_use
    assert len(run["tokens"]) == n, len(run["tokens"])
    for toks in run["tokens"].values():
        assert len(toks) == 32, len(toks)
        assert all(0 <= t < mcfg.vocab_size for t in toks)
    if evicting:
        # a ring wrapped / H2O evicted: positions past the slots held
        run["eviction"], run["slots"] = eng.eviction, eng._num_slots
        run["max_position_held"] = int(
            run["step_logits"][-1]["positions"].max())
        assert run["max_position_held"] >= eng._num_slots, run["slots"]
    return run


def routing_drops(run: dict, reqs, mcfg) -> dict:
    """An MoE drive's dropped routing choices (a token's choice whose
    expert was full in its block), summed over the layers: of the real
    tokens of each admission (its prompt's rows) and of the live lanes of
    each checked decode step; and over every admission and decode step,
    pad rows and idle lanes included (they take capacity as real tokens
    do)."""
    from repro_torch.models import moe
    plen = {r.uid: r.prompt_len for r in reqs}
    admit = {u: moe.kept_counts(kept[:, :plen[u]])[1]
             for u, (_, kept) in run["admit_routes"].items()}
    steps = []
    for st in run["step_logits"]:
        lanes = [i for i, u in enumerate(st["uids"])
                 if u in st["held"] and len(st["held"][u]) < 32]
        steps.append(moe.kept_counts(st["routes"][1][:, lanes])[1])
    t = run["route_totals"]
    return dict(real_tokens_per_admission=admit,
                real_lanes_per_checked_step=steps, all_rows=t,
                dropped_per_admission=t["admission_dropped"]
                / max(run["admissions"], 1),
                dropped_per_decode_step=t["decode_dropped"]
                / max(run["decode_steps"], 1))


def traced_drive_child(out_path: str) -> int:
    """``chip_smoke.py --traced-drive OUT``: the traced paged drive in a
    process of its own. The paged drive's engine (Qwen3-0.6B, the same
    seeded weights and calibration) serves its 8-request trace once,
    which captures its step graph and each prompt bucket's admission
    graph, then a 4-request trace under ``torch.profiler``
    (``profiled_drive``), then one step-graph replay and one replay of
    the largest bucket's admission graph, each traced
    (``traced_replay``). Writes the JSON result to OUT."""
    import torch
    from repro_torch.serving import ContinuousBatchingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    cfg, params, proj = load_model("qwen3-0.6b", 0)
    eng = ContinuousBatchingEngine(cfg, params, proj,
                                   serving=paged_serving())
    serve_drive(eng, drive_trace(8, cfg.vocab_size))
    out = profiled_drive(eng, drive_trace(4, cfg.vocab_size),
                         "aqua_paged_decode")
    out["admit_ms"] = 1e3 * eng.stats.admit_seconds / eng.stats.admissions
    out["step_graph_replay"] = traced_replay(eng.step_graph.graph)
    big = max(eng.admit_graphs)
    out["admit_graph_replay"] = dict(
        bucket=big, **traced_replay(eng.admit_graphs[big].graph))
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def traced_drive(card: str) -> dict:
    """Run ``traced_drive_child`` in a child process and return its
    result; a child that fails, by a crash too, fails the run (its last
    output goes to standard error). A process of its own because in this
    script's long process ``torch.profiler`` (CUPTI) crashed inside
    ``cuGraphLaunch`` on traced graph replays, in runs that had traced the
    kernel phases first (PERF.md §7); a fresh process whose graphs are
    captured before its first trace has not. It runs before the kernel
    phases, while this process holds next to nothing on the device."""
    import torch
    free, total = torch.cuda.mem_get_info()
    log(f"[serve paged, traced] device memory free {free} of {total} bytes "
        f"as the child starts")
    out = os.path.join(ROOT, "build", "traced_drive.json")
    if os.path.exists(out):
        os.remove(out)
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        TRACED_DRIVE_FLAG, out], capture_output=True,
                       text=True, timeout=600,
                       env={**os.environ, "PYTHONFAULTHANDLER": "1"})
    if r.returncode != 0:
        tail = "\n".join((r.stdout + r.stderr).splitlines()[-40:])
        log("[serve paged, traced] child process's last output:\n" + tail)
        print(tail, file=sys.stderr, flush=True)
        raise RuntimeError(f"traced drive failed: exit {r.returncode}")
    with open(out) as f:
        result = json.load(f)
    os.remove(out)
    idle = (f"{result['idle_share']:.3f}" if result["trace_complete"] else
            f"not measured (the profiler recorded "
            f"{result['traced_decode_passes']} of "
            f"{result['decode_launches']} decode launches)")
    log(f"[serve paged, traced] device idle share {idle}, decode step ms "
        f"{result['decode_step_ms']:.3f}, admission ms "
        f"{result['admit_ms']:.3f} (child process) on {card}")
    log_time("traced drive")
    return result


def drive_config(name: str, dtype: str = "bfloat16", layers: int = None):
    """A registered config at its published width and depth (``layers``:
    its depth cut to that many layers) in ``dtype``, with AQUA (K_RATIO,
    BLOCK_DIMS) where it has attention."""
    from repro_torch.configs import AquaConfig, get_config
    mcfg = dataclasses.replace(get_config(name), dtype=dtype,
                               param_dtype=dtype)
    if layers is not None:
        mcfg = dataclasses.replace(mcfg, num_layers=layers)
    if mcfg.attention is not None:
        mcfg = mcfg.with_aqua(AquaConfig(k_ratio=K_RATIO,
                                         block_dims=BLOCK_DIMS))
    return mcfg


def load_model(name: str, seed: int, dtype: str = "bfloat16",
               calib_seq: int = 32, layers: int = None,
               calibrate_proj: bool = True) -> tuple:
    """A model at its published width and depth (``layers``: its depth
    cut to that many layers) with AQUA (K_RATIO, BLOCK_DIMS), random
    weights and activations of ``dtype`` from ``seed``, and projections
    calibrated on ``calib_seq``-token windows of the corpus (with a
    frontend's stub inputs; None without ``calibrate_proj``): (config,
    params, projections)."""
    import torch
    from repro_torch.core.calibration import calibrate, capture_forward
    from repro_torch.data.corpus import calibration_batches
    from repro_torch.models import build_model
    from repro_torch.models.layers import with_unembedding
    mcfg = drive_config(name, dtype, layers)
    model = build_model(mcfg)
    # the float32 unembedding made once, as the engines and the launcher
    # make it
    mparams = with_unembedding(
        model.init(torch.Generator(device="cuda").manual_seed(seed)),
        model.tied_unembedding)
    if mcfg.aqua is None or not calibrate_proj:
        return mcfg, mparams, None   # attention-free: nothing to calibrate
    mproj = calibrate(capture_forward(model), mparams, calibration_batches(
        mcfg.vocab_size, os.path.join(ROOT, "corpora", "calibration.txt"),
        num_batches=2, batch=2, seq=calib_seq, model_cfg=mcfg), mcfg)
    return mcfg, mparams, mproj


def serve_phase(card: str, prof: dict) -> dict:
    """The drives (module docstring, section 4); ``prof``: the traced
    paged drive's result (``traced_drive``), reported with them."""
    from repro_torch.configs import (CacheSpec, QuantSpec, ServingConfig,
                                     SparsitySpec)

    t0 = time.perf_counter()
    cfg, params, proj = load_model("qwen3-0.6b", 0)
    aqua = cfg.aqua
    danube, danube_params, danube_proj = load_model("h2o-danube-1.8b", 1)
    weights = {cfg.name: (params, proj),
               danube.name: (danube_params, danube_proj)}
    setup_s = time.perf_counter() - t0
    log_time("serve set-up (weights, calibration)")

    def trace(n, prompts=(128, 512, 1024), vocab=cfg.vocab_size,
              shared_prefix=0):
        return drive_trace(n, vocab, prompts, shared_prefix)
    paged = paged_serving()
    # prefix sharing on (CacheSpec's default, as in JAX)
    prefix = dataclasses.replace(paged, cache=CacheSpec(page_size=64))
    int8 = QuantSpec(kv_dtype="int8")
    # mixed precision: a quarter of the int8 pool's pages also kept in bf16
    hot = QuantSpec(kv_dtype="int8", hot_resident_fraction=0.25)
    hier = SparsitySpec(page_keep_ratio=0.25)
    aqua_off = dataclasses.replace(cfg, aqua=None)
    long_prompts = (512, 1024)        # 9+ of 32 pages: 8 participate
    # every admission chunks: 512 and 1024 tokens in chunks of at most 256
    # (a multiple of the bucket, the page and prefill_q_blk 128)
    chunked = dataclasses.replace(paged, prefill_budget_tokens=256)
    # sliding window: Danube's 4096-slot rings (64 pages per lane) under
    # prompts past the window, so the window masks inside the prefill and
    # decode starts on a wrapped ring (decode: the masked-dense core)
    swa = ServingConfig(max_lanes=4, max_seq=8192, max_new_tokens=32,
                        cache=CacheSpec(page_size=64, prefix_sharing=False))
    swa_prompts = (4160, 4480, 4800, 5120)
    # H2O: a 1024-slot budget (16 pages) and 512 recents; the prompts
    # never evict, evict mid-decode, from the first step, and choose heavy
    # hitters at prefill
    h2o_cfg = dataclasses.replace(cfg, aqua=dataclasses.replace(
        aqua, h2o_ratio=0.5, h2o_recent_frac=0.5))
    h2o_prompts = (512, 1000, 1024, 1536)
    # AQUA-Memory: 90 of 128 dims kept (blocks of 2), stored as 96
    memory_cfg = dataclasses.replace(cfg, aqua=dataclasses.replace(
        aqua, s_ratio=0.3, block_dims=2))
    # (path, model config, serving, requests, prompts, reference backend,
    #  the kernel launched once per layer per admission, and per step)
    drives = (
        ("paged", cfg, paged, 8, None, "aqua-block-sparse-plain",
         "aqua_prefill", "aqua_paged_decode"),
        ("contiguous", cfg, dataclasses.replace(paged, cache=None), 4, None,
         "aqua-block-sparse-plain", "aqua_prefill", "aqua_decode"),
        ("flash_paged", aqua_off, paged, 4, None, "dense",
         "flash_attention", None),
        ("int8_paged", cfg, dataclasses.replace(paged, quant=int8), 4, None,
         "aqua-block-sparse-plain", "aqua_prefill",
         "aqua_paged_quant_decode"),
        ("hier_paged", cfg, dataclasses.replace(paged, sparsity=hier), 4,
         long_prompts, "aqua-block-sparse-plain", "aqua_prefill",
         "aqua_paged_part_decode"),
        ("hier_int8_paged", cfg,
         dataclasses.replace(paged, quant=int8, sparsity=hier), 4,
         long_prompts, "aqua-block-sparse-plain", "aqua_prefill",
         "aqua_paged_part_quant_decode"),
        ("chunked_paged", cfg, chunked, 4, long_prompts,
         "aqua-block-sparse-plain", "aqua_prefill", "aqua_paged_decode"),
        ("swa_paged", danube, swa, 4, swa_prompts,
         "aqua-block-sparse-plain", "aqua_prefill", None),
        ("h2o_paged", h2o_cfg, dataclasses.replace(paged, max_lanes=4), 4,
         h2o_prompts, "aqua-block-sparse-plain", "aqua_prefill", None),
        ("aqua_memory_paged", memory_cfg, paged, 4, None,
         "aqua-block-sparse-plain", "aqua_prefill", "aqua_paged_decode"),
        ("prefix_paged", cfg, prefix, 8, None, "aqua-block-sparse-plain",
         "aqua_prefill", "aqua_paged_decode"),
        # int8 pools under the window ring (decode on a wrapped ring) and
        # under H2O, and hot residents: decode on the masked-dense core
        # over the dequantized (resident-overlaid) view, as in JAX
        ("int8_swa_paged", danube, dataclasses.replace(swa, quant=int8), 4,
         swa_prompts, "aqua-block-sparse-plain", "aqua_prefill", None),
        ("int8_h2o_paged", h2o_cfg,
         dataclasses.replace(paged, max_lanes=4, quant=int8), 4,
         h2o_prompts, "aqua-block-sparse-plain", "aqua_prefill", None),
        ("hot_int8_paged", cfg, dataclasses.replace(paged, quant=hot), 4,
         None, "aqua-block-sparse-plain", "aqua_prefill", None))

    def drive(mcfg, serving, n, prompts, backend=None,
              shared_prefix=0) -> dict:
        return run_drive(mcfg, *weights[mcfg.name], serving, n, prompts,
                         backend, shared_prefix)

    runs = {}
    for (path, mcfg, serving, n, prompts, ref_backend, admit_kernel,
         step_kernel) in drives:
        shared = SHARED_PREFIX.get(path, 0)
        ref = drive(mcfg, serving, n, prompts, backend=ref_backend,
                    shared_prefix=shared)
        assert sum(ref["launches"].values()) == 0, (path, ref["launches"])
        del ref["engine"]             # its cache is freed before the next
        run = drive(mcfg, serving, n, prompts, shared_prefix=shared)
        assert run["prefix_hits"] == ref["prefix_hits"], path
        run["reference_drive_peak_memory_bytes"] = ref[
            "drive_peak_memory_bytes"]
        run["reference_decode_step_ms"] = ref["decode_step_ms"]
        run["reference_capture_ms"] = ref["capture_ms"]
        if serving.prefill_budget_tokens is not None:
            assert run["chunked_admissions"] == n, run["chunked_admissions"]
            assert run["prefill_chunks"] > n, run["prefill_chunks"]
        want = dict.fromkeys(KERNELS, 0)
        layers = mcfg.num_layers
        # once per layer per fresh monolithic admission and per prefill
        # chunk (a prefix-shared admission's tail runs the reference chunk
        # step, as in JAX)
        want[admit_kernel] = layers * (run["admissions"]
                                       - run["chunked_admissions"]
                                       + run["prefill_chunks"]
                                       - run["prefix_hits"])
        if step_kernel is not None:
            want[step_kernel] = layers * run["decode_steps"]
        assert run["launches"] == want, (path, run["launches"], want)
        eng = run["engine"]
        if serving.sparsity is not None:
            assert eng.kept_pages is not None \
                and eng.kept_pages < eng.pages_per_lane, \
                (eng.kept_pages, eng.pages_per_lane)
            run["kept_pages"] = eng.kept_pages
            run["pages_per_lane"] = eng.pages_per_lane
        run["reference"] = ref_backend
        run["vs_reference"] = compare_logits(run, ref, 32)
        run["cache_bytes"] = eng.cache_bytes()
        runs[path] = run
        log_time(f"drive {path} and its reference")
    # prefix sharing: every admission after the first maps the first
    # prompt's 8 prefix pages (it holds them while it decodes) and
    # prefills only its tail; against the same trace unshared, the pool's
    # peak; a second serve, where the fresh admission replays its graph
    pre = runs["prefix_paged"]
    plen = SHARED_PREFIX["prefix_paged"]
    assert (pre["prefix_hits"], pre["tokens_saved"]) == (7, 7 * plen), pre
    unshared = drive(cfg, paged, 8, None, shared_prefix=plen)
    pre["unshared_peak_pages_in_use"] = unshared["peak_pages_in_use"]
    del unshared
    assert pre["peak_pages_in_use"] < pre["unshared_peak_pages_in_use"], pre
    eng = pre["engine"]

    def admit_ms(st) -> dict:
        hits = eng.page_pool.prefix_hits
        return dict(shared=1e3 * st.shared_admit_seconds / hits,
                    fresh=1e3 * (st.admit_seconds - st.shared_admit_seconds)
                    / (st.admissions - hits))
    pre["admit_ms_by_kind"] = admit_ms(eng.stats)
    reset_counts()
    again = serve_drive(eng, trace(8, shared_prefix=plen))
    assert again["tokens"] == pre["tokens"], "second serve changed tokens"
    assert eng.page_pool.prefix_hits == 7
    want = dict.fromkeys(KERNELS, 0)
    want["aqua_prefill"] = cfg.num_layers * (again["admissions"] - 7)
    want["aqua_paged_decode"] = cfg.num_layers * again["decode_steps"]
    assert launch_counts() == want, (launch_counts(), want)
    pre["second_serve"] = dict(
        admit_ms_by_kind=admit_ms(eng.stats), **{
            k: v for k, v in again.items()
            if k not in ("tokens", "admit_logits", "step_logits")})
    log(f"[serve prefix_paged] prefix hits {pre['prefix_hits']}, prefill "
        f"tokens saved {pre['tokens_saved']}, peak pages in use "
        f"{pre['peak_pages_in_use']} (unshared: "
        f"{pre['unshared_peak_pages_in_use']}); admission host ms, shared "
        f"(eager) / fresh: first serve {pre['admit_ms_by_kind']}, second "
        f"serve {pre['second_serve']['admit_ms_by_kind']} on {card}")
    log_time("drive prefix_paged unshared and served again")
    # the chunked trace served monolithically with the kernels: tokens and
    # inter-token gaps beside the chunked drive's (reported, not limited),
    # the gaps from each engine's second serve of the trace (its graphs
    # captured, as a running server's are)
    chunk_run = runs["chunked_paged"]
    mono = drive(cfg, paged, 4, long_prompts)
    pairs = [(a, b) for u in mono["tokens"]
             for a, b in zip(chunk_run["tokens"][u], mono["tokens"][u])]
    again = {k: serve_drive(r["engine"], trace(4, long_prompts))
             for k, r in (("chunked", chunk_run), ("monolithic", mono))}
    chunk_run["vs_monolithic"] = dict(
        greedy_token_match=sum(a == b for a, b in pairs) / len(pairs),
        **{k: (again["chunked"][k], again["monolithic"][k])
           for k in ("itl_p50_ms", "itl_p99_ms", "max_itl_ms", "admit_ms")})
    log(f"[serve chunked_paged] second serves, chunked vs monolithic: "
        f"{chunk_run['vs_monolithic']} on {card}")
    log_time("drive chunked_paged served monolithically")
    # the paged drive's trace served again on its engine: every bucket's
    # admission graph is captured, so every admission replays
    eng = runs["paged"]["engine"]
    reset_counts()
    again = serve_drive(eng, trace(8))
    assert again["tokens"] == runs["paged"]["tokens"], \
        "second serve changed tokens"
    want = dict.fromkeys(KERNELS, 0)
    want["aqua_prefill"] = cfg.num_layers * again["admissions"]
    want["aqua_paged_decode"] = cfg.num_layers * again["decode_steps"]
    assert launch_counts() == want, (launch_counts(), want)
    runs["paged"]["second_serve"] = {
        k: v for k, v in again.items()
        if k not in ("tokens", "admit_logits", "step_logits")}
    log(f"[serve paged, second serve] admission ms {again['admit_ms']:.3f} "
        f"(first serve, captures included: "
        f"{runs['paged']['admit_ms']:.3f}), gap p50/p99/max "
        f"{again['itl_p50_ms']:.1f}/{again['itl_p99_ms']:.1f}/"
        f"{again['max_itl_ms']:.1f} ms, decode step ms "
        f"{again['decode_step_ms']:.3f}, tokens/s "
        f"{again['tokens_per_s']:.2f} on {card}")
    log_time("drive paged served again")
    int8_share = runs["int8_paged"]["cache_bytes"] / runs["paged"][
        "cache_bytes"]
    assert int8_share < 0.60, int8_share
    # this slice's int8 pools against the bf16 pools of the same geometry:
    # the ring's and H2O's below the int8 gate; hot residents between the
    # int8 pool and the bf16 one
    for key, base in (("int8_swa_paged", "swa_paged"),
                      ("int8_h2o_paged", "h2o_paged"),
                      ("hot_int8_paged", "paged")):
        share = runs[key]["cache_bytes"] / runs[base]["cache_bytes"]
        runs[key]["kv_bytes_vs_bf16"] = dict(
            bytes=runs[key]["cache_bytes"], bf16_drive=base,
            bf16_bytes=runs[base]["cache_bytes"], share=share)
        log(f"[serve {key}] KV pool bytes {runs[key]['cache_bytes']} of the "
            f"bf16 drive {base}'s {runs[base]['cache_bytes']} ({share:.4f}), "
            f"launches {runs[key]['launches']} on {card}")
        if key == "hot_int8_paged":
            assert int8_share < share < 1.0, (int8_share, share)
        else:
            assert share < 0.60, (key, share)
    hot_run = runs["hot_int8_paged"]
    assert hot_run["resident_promotions_seen"] > 0, hot_run
    log(f"[serve hot_int8_paged] {hot_run['hot_pages']} resident pages of "
        f"{runs['hot_int8_paged']['engine'].pool_geometry[0]}; promotions "
        f"seen {hot_run['resident_promotions_seen']}, residents at the end "
        f"by layer {hot_run['residents_at_end']} on {card}")
    # AQUA-Memory: the padded K̂ pool against the full-width one
    mem = runs["aqua_memory_paged"]
    att, maq = memory_cfg.attention, memory_cfg.aqua
    mem["kv_bytes"] = dict(
        bytes=mem["cache_bytes"], full_width_bytes=runs["paged"][
            "cache_bytes"],
        share=mem["cache_bytes"] / runs["paged"]["cache_bytes"],
        head_dim=att.head_dim, kept_dims=maq.kept_dims(att.head_dim),
        stored_dims=mem["engine"].model._cache_dims()[0])
    log(f"[serve aqua_memory_paged] KV bytes {mem['cache_bytes']} of the "
        f"full-width pool's {runs['paged']['cache_bytes']} "
        f"({mem['kv_bytes']['share']:.4f}); K̂ {mem['kv_bytes']['kept_dims']}"
        f" dims stored as {mem['kv_bytes']['stored_dims']} of "
        f"{att.head_dim} on {card}")
    for key in ("swa_paged", "h2o_paged", "aqua_memory_paged",
                "int8_swa_paged", "int8_h2o_paged", "hot_int8_paged"):
        log(f"[serve {key}] peak device memory "
            f"{runs[key]['peak_memory_bytes']} bytes, "
            f"{runs[key]['drive_peak_memory_bytes']} over the drive's start "
            f"(its plain reference: "
            f"{runs[key]['reference_drive_peak_memory_bytes']}) on {card}")
    # the captured step against eager decode_step, bit for bit
    graph_checks = {}
    for path, n, prompts in (("paged", 8, None), ("int8_paged", 4, None),
                             ("hier_int8_paged", 4, long_prompts),
                             ("h2o_paged", 4, h2o_prompts),
                             ("swa_paged", 4, swa_prompts),
                             ("prefix_paged", 8, None),
                             ("int8_swa_paged", 4, swa_prompts),
                             ("int8_h2o_paged", 4, h2o_prompts),
                             ("hot_int8_paged", 4, None)):
        eng = runs[path]["engine"]
        reqs = trace(n, (128, 512, 1024) if prompts is None else prompts,
                     eng.cfg.vocab_size, SHARED_PREFIX.get(path, 0))
        graph_checks[path] = step_graph_phase(path, eng, reqs)
        log({"step_graph": graph_checks[path]})
        log_time(f"step graph {path}")
    # the captured admissions against eager ones, bit for bit
    admit_checks = {}
    for path in ("paged", "contiguous", "flash_paged", "int8_paged",
                 "hier_paged", "hier_int8_paged", "aqua_memory_paged",
                 "hot_int8_paged"):
        admit_checks[path] = admit_graph_phase(path, runs[path]["engine"])
        log({"admit_graph": admit_checks[path]})
        log_time(f"admit graph {path}")

    summary = {}
    for key, run in runs.items():
        summary[key] = {k: v for k, v in run.items()
                        if k not in ("tokens", "admit_logits", "step_logits",
                                     "engine")}
        log(f"[serve {key}] tokens/s {run['tokens_per_s']:.2f} on {card}")
        log(f"[serve {key}] decode step ms {run['decode_step_ms']:.3f}, "
            f"capture ms {run['capture_ms']:.1f}, graph pool bytes "
            f"{run['graph_pool_bytes']} (its plain reference: decode step "
            f"ms {run['reference_decode_step_ms']:.3f}) on {card}")
        acc = run["graphs"]
        log(f"[serve {key}] admission ms {run['admit_ms']:.3f}, admission "
            f"graphs {acc['admit_graphs']} (capture ms by bucket "
            f"{acc['admit_capture_ms']}), shared pool bytes "
            f"{acc['admit_pool_bytes']}, step graph pool bytes "
            f"{acc['step_pool_bytes']} on {card}")
    result = dict(model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
                  models={m.name: dict(layers=m.num_layers, d_model=m.d_model,
                                       head_dim=m.attention.head_dim,
                                       window=m.attention.window)
                          for m in (cfg, danube)},
                  setup_s=setup_s, logit_rtol=LOGIT_RTOL,
                  profile_paged=prof, int8_cache_bytes_share=int8_share,
                  step_graph=graph_checks, admit_graph=admit_checks,
                  **summary)
    log({"serve": result})
    return result


#: the dense configs whose GQA groups no other drive runs: Qwen1.5-4B
#: (MHA, group 1, q/k/v biases) and Minitron-4B (group 3), with their seeds
# (config, weight seed, lanes, requests, prompt lengths): the dense configs
# of GQA groups 1 and 3, and the MoE family (prompts off the 16-token
# bucket, so that admissions route pad rows with the real ones)
GROUP_CONFIGS = (("qwen1.5-4b", 2, 4, 4, (128, 512, 1024)),
                 ("minitron-4b", 3, 4, 4, (128, 512, 1024)),
                 ("olmoe-1b-7b", 4, 4, 4, (121, 509, 1003)),
                 ("qwen2-moe-a2.7b", 5, 8, 8, (121, 509, 1003)))


def decode_step_bound(mcfg, mparams, ctx: float, lanes: int,
                      extra_bytes: float = 0.0,
                      attn_layers: int = None) -> dict:
    """The bytes one decode step must read and its least time at
    HBM_BYTES_PER_S: every layer's weights (an MoE's dense capacity
    buffers run every expert, so all expert weights; an encoder-decoder's
    decoder layers, not its encoder's; a hybrid's list of layers), the
    float32 unembedding, the lanes' K̂ (its selected share; all of it
    with AQUA off) and V rows at ``ctx`` positions each in
    ``attn_layers`` attention layers (default every layer; none without
    attention), and ``extra_bytes`` (an encoder-decoder's cross K/V, all
    of it read each step; a recurrent state, read and written)."""
    import torch
    from repro_torch.models.layers import UNEMBED_F32

    def nbytes(t):
        if isinstance(t, dict):
            return sum(nbytes(v) for v in t.values())
        if isinstance(t, list):
            return sum(nbytes(v) for v in t)
        return t.numel() * t.element_size()
    att = mcfg.attention
    layers = mparams["dec_layers" if mcfg.family == "encdec" else "layers"]
    weights = nbytes(layers) + nbytes(mparams[UNEMBED_F32])
    experts = 0
    if mcfg.family == "moe":
        experts = sum(nbytes(mparams["layers"]["ffn"][k])
                      for k in ("w1", "w2", "w3"))
    if attn_layers is None:
        attn_layers = 0 if att is None else mcfg.num_layers
    share = K_RATIO if mcfg.aqua is not None else 1.0
    kv = 0.0 if att is None else (
        attn_layers * lanes * ctx * att.num_kv_heads * att.head_dim
        * (share + 1.0) * torch.finfo(torch.bfloat16).bits / 8)
    total = weights + kv + extra_bytes
    return dict(bytes=total, expert_bytes=experts,
                unembedding_bytes=nbytes(mparams[UNEMBED_F32]),
                kv_bytes=kv, extra_bytes=extra_bytes,
                ms=total / HBM_BYTES_PER_S * 1e3)


def config_drive_phase(card: str) -> dict:
    """One engine drive per config of ``GROUP_CONFIGS`` at its published
    width and depth (random bf16 weights, calibrated projections): its
    requests of its prompt lengths, its lanes, 64-token pages, AQUA
    (K_RATIO, BLOCK_DIMS), against its plain reference drive (logits
    within LOGIT_RTOL; for an MoE on the rows both drives routed alike,
    the rest counted), launches exactly the path's, and the step graph
    against eager ``decode_step`` (``step_graph_phase``). An MoE drive
    also holds its admission graphs against eager admissions
    (``admit_graph_phase``) and reports the routing choices dropped at
    admissions and decode steps in both drives, and its decode-step ms
    beside the step's byte bound (``decode_step_bound``). Each config is
    loaded, driven and freed before the next, so that the peak memory is
    one model's."""
    import gc
    import torch
    from repro_torch.serving import ContinuousBatchingEngine
    out = {}
    for name, seed, lanes, n, prompts in GROUP_CONFIGS:
        serving = dataclasses.replace(paged_serving(), max_lanes=lanes)
        t0 = time.perf_counter()
        mcfg, mparams, mproj = load_model(name, seed)
        setup_s = time.perf_counter() - t0
        log_time(f"load {name}")
        moe = mcfg.family == "moe"
        if moe:
            # the kernel drive records its routing; a plain drive routes
            # by itself (the rows it routed alike are few: a bf16 rounding
            # flips near-tied experts and capacity drops), and a plain
            # drive that replays the recording holds every row
            run = run_drive(mcfg, mparams, mproj, serving, n, prompts)
            recorded = run["tape"].calls.tolist()
            free = run_drive(mcfg, mparams, mproj, serving, n, prompts,
                             backend="aqua-block-sparse-plain")
            del free["engine"], free["tape"]
            ref = run_drive(mcfg, mparams, mproj, serving, n, prompts,
                            backend="aqua-block-sparse-plain",
                            tape=(run["tape"], "replay"))
            # the replay made the recording's calls, one for one
            assert run["tape"].calls.tolist() == recorded, \
                (name, recorded, run["tape"].calls.tolist())
        else:
            ref = run_drive(mcfg, mparams, mproj, serving, n, prompts,
                            backend="aqua-block-sparse-plain")
            run = run_drive(mcfg, mparams, mproj, serving, n, prompts)
        assert sum(ref["launches"].values()) == 0, (name, ref["launches"])
        del ref["engine"]
        ref.pop("tape", None)
        want = dict.fromkeys(KERNELS, 0)
        want["aqua_prefill"] = mcfg.num_layers * run["admissions"]
        want["aqua_paged_decode"] = mcfg.num_layers * run["decode_steps"]
        assert run["launches"] == want, (name, run["launches"], want)
        eng = run["engine"]
        att = mcfg.attention
        res = {k: v for k, v in run.items()
               if k not in ("tokens", "admit_logits", "step_logits",
                            "engine", "admit_routes", "tape")}
        res.update(setup_s=setup_s, layers=mcfg.num_layers,
                   d_model=mcfg.d_model, heads=att.num_heads,
                   kv_heads=att.num_kv_heads, group=att.group_size,
                   qkv_bias=att.qkv_bias, cache_bytes=eng.cache_bytes(),
                   reference_drive_peak_memory_bytes=ref[
                       "drive_peak_memory_bytes"],
                   vs_reference=compare_logits(run, ref, 32,
                                               routed=False if moe
                                               else None))
        if moe:
            m = mcfg.moe
            res.update(experts=m.num_experts, top_k=m.top_k,
                       expert_ff=m.expert_ff, shared_experts=m.num_shared,
                       capacity_factor=m.capacity_factor,
                       vs_free_reference=compare_logits(run, free, 32,
                                                        routed=True),
                       free_reference_drops=free["drops"],
                       reference_drops=ref["drops"],
                       decode_step_bound=decode_step_bound(
                           mcfg, mparams, float(sum(prompts)) / len(prompts)
                           + 16, lanes))
            res["admit_graph"] = admit_graph_phase(name, eng)
            log({"admit_graph": res["admit_graph"]})
        # an MoE drive's graphs also write its routing tape: the step
        # graph is held and timed on an engine without one
        res["step_graph"] = step_graph_phase(
            name, ContinuousBatchingEngine(mcfg, mparams, mproj,
                                           serving=serving) if moe else eng,
            drive_trace(lanes, mcfg.vocab_size, prompts))
        log({"step_graph": res["step_graph"]})
        log(f"[serve {name}] group {att.group_size} ({att.num_heads} heads, "
            f"{att.num_kv_heads} KV heads), launches {run['launches']}, KV "
            f"bytes {res['cache_bytes']}, peak device memory "
            f"{run['peak_memory_bytes']} bytes ({run['drive_peak_memory_bytes']}"
            f" over the drive's start), tokens/s {run['tokens_per_s']:.2f}, "
            f"decode step ms {run['decode_step_ms']:.3f}, admission ms "
            f"{run['admit_ms']:.3f} on {card}")
        if moe:
            vs, fv = res["vs_reference"], res["vs_free_reference"]
            b, d = res["decode_step_bound"], run["drops"]
            t = d["all_rows"]
            log(f"[serve {name}] MoE: dropped routing choices per admission "
                f"{d['dropped_per_admission']:.1f} of "
                f"{(t['admission_kept'] + t['admission_dropped']) / run['admissions']:.1f}"
                f" (self-routed plain drive "
                f"{free['drops']['dropped_per_admission']:.1f}), per decode "
                f"step {d['dropped_per_decode_step']:.2f} of "
                f"{(t['decode_kept'] + t['decode_dropped']) / run['decode_steps']:.1f}"
                f" (plain {free['drops']['dropped_per_decode_step']:.2f}), "
                f"real tokens' per admission "
                f"{d['real_tokens_per_admission']}; against the self-routed "
                f"plain drive, rows routed apart (excluded): "
                f"{fv['admissions_routed_apart']} admissions, "
                f"{fv['decode_rows_routed_apart']} decode rows (compared "
                f"{fv['admissions_compared']} and "
                f"{fv['decode_rows_compared']}); against the plain drive "
                f"replaying its routing, every row: "
                f"{vs['admissions_compared']} admissions (worst "
                f"{vs['admit_worst_err_over_limit']:.3f} of the limit), "
                f"{vs['decode_rows_compared']} decode rows (worst "
                f"{vs['decode_worst_err_over_limit']:.3f}); decode step "
                f"{run['decode_step_ms']:.3f} ms host (the tape's "
                f"writes included), graph replay without a tape "
                f"{res['step_graph']['replay_device_ms']:.3f} ms device, "
                f"beside its byte bound {b['ms']:.3f} ms ({b['bytes']:.4g} "
                f"bytes) on {card}")
        out[name] = res
        del run, ref, eng, mparams, mproj, res
        if moe:
            del free
        gc.collect()
        torch.cuda.empty_cache()
        log_time(f"drive {name} and its reference")
    log({"serve_configs": out})
    return out


#: the modality-frontend configs: (config, weight seed, lanes, requests,
#: prompt lengths, paged, max_seq, calibration window, reference replays
#: the kernel drive's selections). Pixtral's prompts lie off the 16-token
#: bucket (pad rows) and hold its 256 patches, and so do its 320-token
#: calibration windows; Whisper's decoder prompts stay within its 448
#: positions and admit at their exact length. Pixtral's plain reference
#: replays the kernel drive's dim-block selections: through 40 layers
#: with the patches, a self-selecting plain drive sits at about the 5%
#: limit, and a float32-activation plain reference equally far from both
#: bf16 drives (PERF.md, PR 28); its rows are reported beside.
FRONTEND_CONFIGS = (("pixtral-12b", 6, 4, 4, (300, 700, 1000), True, 2048,
                     320, True),
                    ("whisper-tiny", 7, 8, 8, (37, 101, 229), False, 448, 32,
                     False))


def frontend_drive_phase(card: str) -> dict:
    """One engine drive per config of ``FRONTEND_CONFIGS`` at its published
    width and depth (random bf16 weights, calibrated projections; every
    request with its own stub frontend inputs: Pixtral's 256 patch
    embeddings of width 1024, Whisper's 1500 frames of width 384), AQUA
    (K_RATIO, BLOCK_DIMS): against its plain reference drive (every
    admission's and checked decode row's logits within LOGIT_RTOL),
    launches exactly the path's (Pixtral: the prefill once per layer per
    admission, the paged decode once per layer per step; Whisper: the
    prefill once per decoder layer per admission, the contiguous decode
    once per decoder layer per step; nothing else: the encoder and the
    cross-attention run no kernel, as in JAX); Pixtral's reference
    replays the kernel drive's dim-block selections
    (``core.aqua.SelectionTape``, call for call) and a self-selecting
    plain drive's rows are reported beside, not held; the step graph
    against
    eager ``decode_step`` (``step_graph_phase``; Whisper's with its cross
    K/V fault), Pixtral's admission graphs (with patches) against eager
    admissions (``admit_graph_phase``, with its patches fault), the
    decode step's graph replay beside its byte bound
    (``decode_step_bound``; Whisper's with its lanes' cross K/V) and the
    peak device memory. Each config is loaded, driven and freed before
    the next."""
    import gc
    import torch
    from repro_torch.configs import ServingConfig
    from repro_torch.models.base import extra_tensors
    from repro_torch.core.aqua import SelectionTape
    out = {}
    for name, seed, lanes, n, prompts, paged, max_seq, calib, replay in \
            FRONTEND_CONFIGS:
        serving = (dataclasses.replace(paged_serving(), max_lanes=lanes)
                   if paged else ServingConfig(max_lanes=lanes,
                                               max_seq=max_seq,
                                               max_new_tokens=32))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mcfg, mparams, mproj = load_model(name, seed, calib_seq=calib)
        setup_s = time.perf_counter() - t0
        log_time(f"load {name}")
        free = None
        if replay:
            tape = SelectionTape("cuda", slots=(8192, 1024),
                                 numel=(lanes * mcfg.attention.num_heads
                                        * 16, 4096))
            run = run_drive(mcfg, mparams, mproj, serving, n, prompts,
                            selection=(tape, "record"))
            recorded = tape.calls.tolist()
            free = run_drive(mcfg, mparams, mproj, serving, n, prompts,
                             backend="aqua-block-sparse-plain")
            del free["engine"]
            ref = run_drive(mcfg, mparams, mproj, serving, n, prompts,
                            backend="aqua-block-sparse-plain",
                            selection=(tape, "replay"))
            # the replay made the recording's calls, one for one
            assert tape.calls.tolist() == recorded and not tape.overflowed, \
                (name, recorded, tape.calls.tolist())
        else:
            ref = run_drive(mcfg, mparams, mproj, serving, n, prompts,
                            backend="aqua-block-sparse-plain")
            run = run_drive(mcfg, mparams, mproj, serving, n, prompts)
        assert sum(ref["launches"].values()) == 0, (name, ref["launches"])
        del ref["engine"]
        want = dict.fromkeys(KERNELS, 0)
        want["aqua_prefill"] = mcfg.num_layers * run["admissions"]
        want["aqua_paged_decode" if paged else "aqua_decode"] = \
            mcfg.num_layers * run["decode_steps"]
        assert run["launches"] == want, (name, run["launches"], want)
        eng = run["engine"]
        att, fe = mcfg.attention, mcfg.frontend
        cross_bytes = sum(t.numel() * t.element_size()
                          for t in extra_tensors(eng.last_state.extra))
        res = {k: v for k, v in run.items()
               if k not in ("tokens", "admit_logits", "step_logits",
                            "engine", "admit_routes", "tape",
                            "selection_tape")}
        res.update(setup_s=setup_s, family=mcfg.family,
                   layers=mcfg.num_layers,
                   encoder_layers=mcfg.num_encoder_layers,
                   d_model=mcfg.d_model, heads=att.num_heads,
                   kv_heads=att.num_kv_heads, head_dim=att.head_dim,
                   frontend=dict(kind=fe.kind, num_embeds=fe.num_embeds,
                                 embed_dim=fe.embed_dim),
                   cache_bytes=eng.cache_bytes(), cross_kv_bytes=cross_bytes,
                   reference_drive_peak_memory_bytes=ref[
                       "drive_peak_memory_bytes"],
                   vs_reference=compare_logits(run, ref, 32),
                   reference_replays_selections=replay,
                   vs_free_reference=None if free is None else
                   compare_logits(run, free, 32, check=False),
                   decode_step_bound=decode_step_bound(
                       mcfg, mparams, float(sum(prompts)) / len(prompts)
                       + 16, lanes, extra_bytes=cross_bytes))
        if paged:
            res["admit_graph"] = admit_graph_phase(name, eng)
            log({"admit_graph": res["admit_graph"]})
        res["step_graph"] = step_graph_phase(
            name, eng, drive_trace(lanes, mcfg.vocab_size, prompts,
                                   mcfg=mcfg))
        log({"step_graph": res["step_graph"]})
        vs, b = res["vs_reference"], res["decode_step_bound"]
        log(f"[serve {name}] {mcfg.family}: launches {run['launches']}, "
            f"{vs['admissions_compared']} admissions (worst "
            f"{vs['admit_worst_err_over_limit']:.3f} of the limit) and "
            f"{vs['decode_rows_compared']} decode rows (worst "
            f"{vs['decode_worst_err_over_limit']:.3f}) against the plain "
            f"drive{' replaying its selections' if replay else ''}, greedy "
            f"token match {vs['greedy_token_match']:.3f}"
            + ("" if free is None else
               f" (a self-selecting plain drive: worst "
               f"{res['vs_free_reference']['admit_worst_err_over_limit']:.3f}"
               f" / {res['vs_free_reference']['decode_worst_err_over_limit']:.3f}"
               f" of the limit, not held)") + f"; KV "
            f"bytes {res['cache_bytes']} (cross K/V {cross_bytes}), peak "
            f"device memory {run['peak_memory_bytes']} bytes; tokens/s "
            f"{run['tokens_per_s']:.2f}, admission ms {run['admit_ms']:.3f}, "
            f"decode step {run['decode_step_ms']:.3f} ms host, graph replay "
            f"{res['step_graph']['replay_device_ms']:.3f} ms device beside "
            f"its byte bound {b['ms']:.3f} ms ({b['bytes']:.4g} bytes) on "
            f"{card}")
        out[name] = res
        del run, ref, free, eng, mparams, mproj, res
        gc.collect()
        torch.cuda.empty_cache()
        log_time(f"drive {name} and its reference")
    log({"serve_frontends": out})
    return out


#: the recurrent configs: (config, weight seed, lanes, requests, prompt
#: lengths, max_seq). RecurrentGemma-9B's prompts run past its 2048-token
#: window (two of three), so its rings wrap at admission; Mamba-2's are the
#: dense drives'.
RECURRENT_CONFIGS = (("recurrentgemma-9b", 8, 4, 4, (1024, 2100, 3000),
                      4096),
                     ("mamba2-370m", 9, 8, 8, (128, 512, 1024), 2048))


def solo_logits(eng, prompt, tokens, n: int, lanes: int = 1) -> list:
    """A request alone on the rectangular ``ServeEngine`` ``eng``: its
    prefill's logits, then those of ``n`` decode steps fed ``tokens``
    (the drive's own, so that both see the same sequence): n + 1 rows
    (1, V), row k the logits after k fed tokens. ``lanes`` > 1: the
    decode steps run on the prefilled state copied into that many rows,
    each fed the same token (the request alone at an engine's lane count:
    the same matrix shapes), row 0 kept."""
    import torch
    logits, state = eng.model.prefill(
        eng.params, {"tokens": torch.as_tensor(
            prompt, dtype=torch.int32, device="cuda")[None]}, eng.max_seq)
    if lanes > 1:
        state.layers = type(state.layers)(**{
            k: t.repeat_interleave(lanes, dim=1)
            for k, t in state_tensors(state.layers).items()})
    rows = [logits.float().clone()]
    for tok in tokens[:n]:
        logits, state = eng.model.decode_step(
            eng.params, state, torch.full((lanes,), int(tok),
                                          dtype=torch.int32, device="cuda"))
        rows.append(logits[:1].float().clone())
    return rows


def compare_solo(run: dict, eng, reqs, lanes: int, check: bool = True,
                 greedy: bool = True) -> dict:
    """Every admission's logits and every checked decode row (a lane still
    generating) of a drive against the request alone on ``eng`` (a
    ``ServeEngine``) fed the same tokens, its decode steps at ``lanes``
    rows (``solo_logits``): each row within LOGIT_RTOL of its largest
    magnitude (raises otherwise, unless ``check`` is off); with
    ``greedy``, also the tokens of ``ServeEngine.generate`` (one row)
    against the drive's (reported)."""
    import numpy as np
    prompts = {r.uid: np.asarray(r.tokens) for r in reqs}
    need = {}
    for st in run["step_logits"]:
        for u, held in st["held"].items():
            if len(held) < 32:
                need[u] = max(need.get(u, 0), len(held))
    solo = {u: solo_logits(eng, prompts[u], run["tokens"][u], need.get(u, 0),
                           lanes) for u in prompts}

    def ratio(got, want, what):
        err = (got - want).abs().max().item()
        limit = LOGIT_RTOL * want.abs().max().item()
        assert err <= limit or not check, f"{what}: error {err} > {limit}"
        return err / limit
    worst_admit = max(ratio(run["admit_logits"][u], rows[0], f"admit {u}")
                      for u, rows in solo.items())
    worst_step, rows, by_step = 0.0, 0, []
    for i, st in enumerate(run["step_logits"]):
        worst_here = 0.0
        for lane, u in enumerate(st["uids"]):
            held = st["held"].get(u)
            if held is None or len(held) >= 32:
                continue
            worst_here = max(worst_here, ratio(
                st["logits"][lane], solo[u][len(held)][0],
                f"step {i} lane {lane} (uid {u})"))
            rows += 1
        by_step.append(worst_here)
        worst_step = max(worst_step, worst_here)
    match = [float(np.mean(np.asarray(eng.generate(
        {"tokens": prompts[u][None]}, steps=32).tokens[0])
        == np.asarray(run["tokens"][u]))) for u in prompts] if greedy else []
    return dict(solo_lanes=lanes, admissions_compared=len(solo),
                decode_rows_compared=rows,
                admit_worst_err_over_limit=worst_admit,
                decode_worst_err_over_limit=worst_step,
                decode_worst_by_step=by_step,
                solo_greedy_token_match=float(np.mean(match)) if greedy
                else None)


def recurrent_drive_phase(card: str) -> dict:
    """The recurrent families at their published width and depth (random
    bf16 weights from seeds; ``RECURRENT_CONFIGS``), contiguous caches,
    each loaded, driven and freed before the next:

    * RecurrentGemma-9B (``hybrid``: 26 RG-LRU blocks, 12 local attention
      blocks of 16 heads over one KV head of 256 dims, window 2048), AQUA
      (K_RATIO, BLOCK_DIMS) with projections calibrated through
      ``forward(capture=True)``: launches exactly the prefill's wide
      kernel once per attention layer per admission and no decode kernel
      (a windowed attention decodes on the masked-dense core, as in JAX);
      the kernel drive records its dim-block selections
      (``core.aqua.SelectionTape``) and is held to a plain drive that
      replays them (every row within LOGIT_RTOL); a self-selecting plain
      drive's rows are reported beside, not held; the step graph against
      eager ``decode_step`` with the stale-token, stale-mask and
      stale-RG-LRU-state faults; the decode step beside its byte bound;
      then AQUA off (the flash kernel's wide kernel, once per attention
      layer per admission) against the ``dense`` reference drive;
    * Mamba-2-370M (``ssm``, no AQUA): no kernel launched, asserted; each
      admission's and checked decode row's logits against the request
      alone on a ``ServeEngine`` fed the same tokens (``compare_solo``);
      the step graph with a stale-SSD-state fault; the decode step beside
      its byte bound (the weights, the unembedding, the SSD states read
      and written);
    * RecurrentGemma-9B cut to 6 layers in float32
      (:func:`recurrent_f32_drives`)."""
    import gc
    import torch
    from repro_torch.configs import ServingConfig
    from repro_torch.core import kvcache as kv
    from repro_torch.core.aqua import SelectionTape
    from repro_torch.serving import ServeEngine
    out = {}
    for name, seed, lanes, n, prompts, max_seq in RECURRENT_CONFIGS:
        serving = ServingConfig(max_lanes=lanes, max_seq=max_seq,
                                max_new_tokens=32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mcfg, mparams, mproj = load_model(name, seed)
        setup_s = time.perf_counter() - t0
        log_time(f"load {name}")
        hybrid = mcfg.family == "hybrid"
        want = dict.fromkeys(KERNELS, 0)
        if hybrid:
            att = mcfg.attention
            tape = SelectionTape("cuda", slots=(8192, 1024),
                                 numel=(lanes * att.num_heads * 32,
                                        att.num_heads * 32 * 32))
            run = run_drive(mcfg, mparams, mproj, serving, n, prompts,
                            selection=(tape, "record"))
            recorded = tape.calls.tolist()
            free = run_drive(mcfg, mparams, mproj, serving, n, prompts,
                             backend="aqua-block-sparse-plain")
            del free["engine"]
            ref = run_drive(mcfg, mparams, mproj, serving, n, prompts,
                            backend="aqua-block-sparse-plain",
                            selection=(tape, "replay"))
            assert tape.calls.tolist() == recorded and not tape.overflowed, \
                (name, recorded, tape.calls.tolist())
            assert sum(ref["launches"].values()) == 0, ref["launches"]
            del ref["engine"]
            n_attn = run["engine"].model.num_attn_layers
            want["aqua_prefill"] = n_attn * run["admissions"]
        else:
            run = run_drive(mcfg, mparams, None, serving, n, prompts)
        assert run["launches"] == want, (name, run["launches"], want)
        eng = run["engine"]
        layers = eng.last_state.layers
        rec = layers.rec if hybrid else layers
        state_bytes = kv.tree_bytes(rec)
        ctx = float(sum(prompts)) / len(prompts) + 16
        res = {k: v for k, v in run.items()
               if k not in ("tokens", "admit_logits", "step_logits",
                            "engine", "admit_routes", "tape",
                            "selection_tape")}
        res.update(setup_s=setup_s, family=mcfg.family,
                   layers=mcfg.num_layers, d_model=mcfg.d_model,
                   cache_bytes=eng.cache_bytes(),
                   recurrent_state_bytes=state_bytes,
                   decode_step_bound=decode_step_bound(
                       mcfg, mparams, min(ctx, att.window) if hybrid else 0,
                       lanes, extra_bytes=2 * state_bytes,
                       attn_layers=n_attn if hybrid else 0))
        if hybrid:
            res.update(attn_layers=n_attn, heads=att.num_heads,
                       kv_heads=att.num_kv_heads, head_dim=att.head_dim,
                       window=att.window,
                       reference_drive_peak_memory_bytes=ref[
                           "drive_peak_memory_bytes"],
                       vs_reference=compare_logits(run, ref, 32),
                       reference_replays_selections=True,
                       vs_free_reference=compare_logits(run, free, 32,
                                                        check=False))
            stale = ("rec.state",)
        else:
            # each request alone, its decode steps at the engine's lane
            # count (held: the same matrix shapes, so what differs is the
            # engine's lane surgery, masks and graph) and at one row
            # (reported: cuBLAS rounds a bf16 product of 1 row otherwise
            # than one of 8, through 48 recurrent layers)
            solo = ServeEngine(mcfg, mparams, None, max_seq=max_seq)
            reqs = drive_trace(n, mcfg.vocab_size, prompts)
            res["vs_solo"] = compare_solo(run, solo, reqs, lanes,
                                          greedy=False)
            res["vs_solo_one_row"] = compare_solo(run, solo, reqs, 1,
                                                  check=False)
            del solo
            # the control: the same weights in float32 (activations too),
            # where a product of one row and one of eight round alike to
            # within float32: the drive against each request alone at one
            # row, held
            f32cfg = dataclasses.replace(mcfg, dtype="float32",
                                         param_dtype="float32")
            f32params = {k: (v.float() if isinstance(v, torch.Tensor)
                             else {kk: vv.float() for kk, vv in v.items()})
                         for k, v in mparams.items()}
            frun = run_drive(f32cfg, f32params, None, serving, n, prompts)
            res["float32_vs_solo_one_row"] = compare_solo(
                frun, ServeEngine(f32cfg, f32params, None, max_seq=max_seq),
                reqs, 1, greedy=False)
            del frun, f32params
            stale = ("state",)
        res["step_graph"] = step_graph_phase(
            name, eng, drive_trace(lanes, mcfg.vocab_size, prompts),
            stale=stale)
        log({"step_graph": res["step_graph"]})
        b = res["decode_step_bound"]
        vs = res.get("vs_reference") or res["vs_solo"]
        log(f"[serve {name}] {mcfg.family}: launches {run['launches']}, "
            f"{vs['admissions_compared']} admissions (worst "
            f"{vs['admit_worst_err_over_limit']:.3f} of the limit) and "
            f"{vs['decode_rows_compared']} decode rows (worst "
            f"{vs['decode_worst_err_over_limit']:.3f}) against "
            + ("the plain drive replaying its selections (a self-selecting "
               f"plain drive: worst "
               f"{res['vs_free_reference']['admit_worst_err_over_limit']:.3f}"
               f" / {res['vs_free_reference']['decode_worst_err_over_limit']:.3f}"
               " of the limit, not held)" if hybrid else
               f"each request alone on a ServeEngine at {lanes} rows "
               f"(at one row: worst "
               f"{res['vs_solo_one_row']['admit_worst_err_over_limit']:.3f}"
               f" / {res['vs_solo_one_row']['decode_worst_err_over_limit']:.3f}"
               " of the limit, not held; its greedy token match "
               f"{res['vs_solo_one_row']['solo_greedy_token_match']:.3f}; "
               "in float32 at one row: worst "
               f"{res['float32_vs_solo_one_row']['admit_worst_err_over_limit']:.3f}"
               f" / {res['float32_vs_solo_one_row']['decode_worst_err_over_limit']:.3f})")
            + f"; cache bytes {res['cache_bytes']} (recurrent state "
            f"{state_bytes}), peak device memory {run['peak_memory_bytes']} "
            f"bytes; tokens/s {run['tokens_per_s']:.2f}, admission ms "
            f"{run['admit_ms']:.3f}, decode step {run['decode_step_ms']:.3f}"
            f" ms host, graph replay "
            f"{res['step_graph']['replay_device_ms']:.3f} ms device beside "
            f"its byte bound {b['ms']:.3f} ms ({b['bytes']:.4g} bytes) on "
            f"{card}")
        out[name] = res
        del run, eng, layers, rec
        if hybrid:
            del ref, free, tape
            gc.collect()
            torch.cuda.empty_cache()
            # AQUA off: the flash kernel's wide kernel at every admission
            off = dataclasses.replace(mcfg, aqua=None)
            fref = run_drive(off, mparams, None, serving, n, prompts,
                             backend="dense")
            assert sum(fref["launches"].values()) == 0, fref["launches"]
            del fref["engine"]
            frun = run_drive(off, mparams, None, serving, n, prompts)
            fwant = dict.fromkeys(KERNELS, 0)
            fwant["flash_attention"] = n_attn * frun["admissions"]
            assert frun["launches"] == fwant, (frun["launches"], fwant)
            fres = {k: v for k, v in frun.items()
                    if k not in ("tokens", "admit_logits", "step_logits",
                                 "engine", "admit_routes", "tape",
                                 "selection_tape")}
            fres["vs_reference"] = fvs = compare_logits(frun, fref, 32)
            log(f"[serve {name}, AQUA off] launches {frun['launches']}, "
                f"{fvs['admissions_compared']} admissions (worst "
                f"{fvs['admit_worst_err_over_limit']:.3f} of the limit) and "
                f"{fvs['decode_rows_compared']} decode rows (worst "
                f"{fvs['decode_worst_err_over_limit']:.3f}) against the "
                f"dense drive; admission ms {frun['admit_ms']:.3f} on {card}")
            out[name + "_flash"] = fres
            del frun, fref
        del mparams, mproj
        gc.collect()
        torch.cuda.empty_cache()
        log_time(f"drive {name} and its reference")
    out.update(recurrent_f32_drives(card))
    log({"serve_recurrent": out})
    return out


#: the float32 hybrid drive: RecurrentGemma-9B at full width, its depth cut
#: to two (recurrent, recurrent, attention) groups, float32 params and
#: activations (as a float32 run computes it), the bf16 drive's trace
RECURRENT_F32 = ("recurrentgemma-9b", 10, 6)


def recurrent_f32_drives(card: str) -> dict:
    """``recurrentgemma-9b_f32``: RecurrentGemma-9B at full width, 6 layers
    (2 attention layers of 16 heads over one KV head of 256 dims, window
    2048), float32 params and activations, 4 lanes, prompts 1024/2100/3000
    (two past the window), AQUA (K_RATIO, BLOCK_DIMS, projections
    calibrated through ``forward(capture=True)``): the float32 prefill
    exactly once per attention layer per admission and no other kernel;
    every admission's and checked decode row's logits within the float32
    drives' limit, |got - want| <= HF_LOGIT_SCALE * (F32_RTOL * |want| +
    F32_ATOL), of a plain drive replaying its dim-block selections. Then
    ``recurrentgemma-9b_f32_flash``, AQUA off: the float32 flash exactly
    once per attention layer per admission, against the ``dense`` drive
    at the same limit."""
    import gc
    import torch
    from repro_torch.configs import ServingConfig
    from repro_torch.core.aqua import SelectionTape
    name, seed, layers = RECURRENT_F32
    _, _, lanes, n, prompts, max_seq = next(
        c for c in RECURRENT_CONFIGS if c[0] == name)
    serving = ServingConfig(max_lanes=lanes, max_seq=max_seq,
                            max_new_tokens=32)
    t0 = time.perf_counter()
    mcfg, mparams, mproj = load_model(name, seed, dtype="float32",
                                      layers=layers)
    setup_s = time.perf_counter() - t0
    att = mcfg.attention
    out = {}
    for aqua in (True, False):
        cfg = mcfg if aqua else dataclasses.replace(mcfg, aqua=None)
        key = f"{name}_f32" + ("" if aqua else "_flash")
        tape = SelectionTape("cuda", slots=(8192, 1024),
                             numel=(lanes * att.num_heads * 32,
                                    att.num_heads * 32 * 32))
        run = run_drive(cfg, mparams, mproj, serving, n, prompts,
                        selection=(tape, "record") if aqua else None)
        ref = run_drive(cfg, mparams, mproj, serving, n, prompts,
                        backend="aqua-block-sparse-plain" if aqua
                        else "dense",
                        selection=(tape, "replay") if aqua else None)
        assert sum(ref["launches"].values()) == 0, ref["launches"]
        n_attn = run["engine"].model.num_attn_layers
        want = dict.fromkeys(KERNELS, 0)
        want["aqua_prefill" if aqua else "flash_attention"] = \
            n_attn * run["admissions"]
        assert run["launches"] == want, (key, run["launches"], want)
        vs = compare_logits(run, ref, 32, per_element=True,
                            scale=HF_LOGIT_SCALE)
        res = {k: v for k, v in run.items()
               if k not in ("tokens", "admit_logits", "step_logits",
                            "engine", "admit_routes", "tape",
                            "selection_tape")}
        res.update(setup_s=setup_s, layers=mcfg.num_layers,
                   attn_layers=n_attn, dtype="float32", vs_reference=vs,
                   reference_replays_selections=aqua,
                   logit_limit=dict(f32_rtol=F32_RTOL, f32_atol=F32_ATOL,
                                    scale=HF_LOGIT_SCALE))
        log(f"[serve {key}] launches {run['launches']}, "
            f"{vs['admissions_compared']} admissions (worst "
            f"{vs['admit_worst_err_over_limit']:.4f} of the float32 limit) "
            f"and {vs['decode_rows_compared']} decode rows (worst "
            f"{vs['decode_worst_err_over_limit']:.4f}) against the "
            + ("plain drive replaying its selections" if aqua
               else "dense drive")
            + f"; tokens/s {run['tokens_per_s']:.2f}, admission ms "
            f"{run['admit_ms']:.3f}, peak device memory "
            f"{run['peak_memory_bytes']} bytes on {card}")
        out[key] = res
        del run, ref, tape
        gc.collect()
        torch.cuda.empty_cache()
    del mparams, mproj
    gc.collect()
    torch.cuda.empty_cache()
    log_time(f"drive {name}_f32 and its references")
    return out


# ---------------------------------------------------------------------------
# Serving an HF checkpoint through the launcher (float32 routes)
# ---------------------------------------------------------------------------


HF_DIR = os.path.join(ROOT, "build", "hf_qwen3_0_6b")
BF16_INPUTS_CONTROL = "aqua-block-sparse-plain-bf16-inputs"


def register_bf16_inputs_control() -> str:
    """Register the control backend: the plain versions of the block-sparse
    backend with their q, k and v arguments rounded to bf16 and widened
    back, as a float32 route that read its inputs at bf16 precision would
    compute; returns its name."""
    import functools
    import torch
    from repro_torch.core import attention as attn_lib
    from repro_torch.kernels.aqua_decode import aqua_decode_plain
    from repro_torch.kernels.aqua_prefill import aqua_prefill_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain

    def bf16_inputs(fn):
        def rounded(q, k, v, *args, **kw):
            def r(t):
                return t.to(torch.bfloat16).to(t.dtype)
            return fn(r(q), r(k), r(v), *args, **kw)
        return rounded
    attn_lib.register_backend(attn_lib._block_sparse_backend(
        BF16_INPUTS_CONTROL, bf16_inputs(aqua_prefill_plain),
        bf16_inputs(functools.partial(aqua_decode_plain, page_table=None)),
        bf16_inputs(aqua_decode_plain),
        attn_lib._flash_backend("flash-plain-bf16-inputs",
                                bf16_inputs(flash_attention_plain))))
    return BF16_INPUTS_CONTROL


def hf_serve_phase(card: str, gen) -> dict:
    """Write Qwen3-0.6B's full width and depth as a synthetic HF checkpoint
    (bf16 stored, tied, two shards, seeded), serve it through the port's
    launcher, ``repro_torch.launch.serve.main``, with ``--verify`` (float32
    params and activations, as ``config_from_hf`` gives them, so the
    float32 group decode route and the float32 prefill), then: re-serve
    the same trace on the launcher's engine (its second serve through the
    captured step graph; tokens must equal the first) with the launch
    counters zeroed just before and read just after, a plain reference
    drive (``aqua-block-sparse-plain``) on the same loaded params whose
    logits must match per element within the float32 limits, the
    engine's step graph against eager decode (``step_graph_phase``), the
    launcher at ``--block-dims 1`` (flash on the masked q̂) with
    ``--verify`` and exact launches, and the float32 kernel routes at the
    drives' shapes (the decode paged and contiguous) against their plain
    versions."""
    import gc
    import shutil
    import torch
    from repro_torch.checkpoint.fixtures import write_hf_fixture
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.serving import ContinuousBatchingEngine

    cfg = get_config("qwen3-0.6b")
    att = cfg.attention
    overrides = {"_name_or_path": "qwen3-0.6b-synthetic",
                 "hidden_size": cfg.d_model,
                 "num_hidden_layers": cfg.num_layers,
                 "num_attention_heads": att.num_heads,
                 "num_key_value_heads": att.num_kv_heads,
                 "head_dim": att.head_dim, "intermediate_size": cfg.d_ff,
                 "vocab_size": cfg.vocab_size, "rope_theta": att.rope_theta,
                 "rms_norm_eps": cfg.norm_eps}
    gc.collect()                   # the earlier drives' engines and graphs
    torch.cuda.empty_cache()
    shutil.rmtree(HF_DIR, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        write_hf_fixture(HF_DIR, seed=0, variant="sharded", tied=True,
                         dtype="bfloat16", config_overrides=overrides,
                         device="cuda")
        write_s = time.perf_counter() - t0
        files = sorted(os.listdir(HF_DIR))
        nbytes = sum(os.path.getsize(os.path.join(HF_DIR, f)) for f in files)
        log(f"[hf_serve] wrote {nbytes} bytes ({', '.join(files)}) in "
            f"{write_s:.2f} s")
        torch.cuda.empty_cache()
        argv = ["--hf-checkpoint", HF_DIR, "--calibration-corpus",
                os.path.join(ROOT, "corpora", "calibration.txt"),
                "--k-ratio", str(K_RATIO), "--block-dims", str(BLOCK_DIMS),
                "--page-size", "64", "--lanes", "8",
                "--requests", "8", "--prompt-lens", "128,512,1024",
                "--steps", "32", "--max-seq", "2048", "--verify"]
        log("[hf_serve] python -m repro_torch.launch.serve " + " ".join(argv))
        reset_counts()
        run = launcher.main(argv)     # raises SystemExit(1) if --verify fails
        main_launches = launch_counts()
        log_time("hf_serve launcher with --verify")
        # the launcher's default block_dims 1 (per-dim selection): prefill
        # runs flash on the masked q̂, decode the masked-dense core
        argv1 = argv[:argv.index("--block-dims")] + ["--block-dims", "1"] \
            + argv[argv.index("--block-dims") + 2:]
        log("[hf_serve] python -m repro_torch.launch.serve "
            + " ".join(argv1))
        reset_counts()
        run1 = launcher.main(argv1)
        per_dim_launches = launch_counts()
        log_time("hf_serve launcher at block_dims 1 with --verify")
        # prefix sharing through the launcher: every prompt behind one
        # 512-token prefix, at the default block_dims 1; --verify holds the
        # tokens to the contiguous reference and fails if nothing was
        # shared
        cut = argv.index("--block-dims")
        argv_pre = argv[:cut] + argv[cut + 2:] + [
            "--shared-prefix-len", str(SHARED_PREFIX["prefix_paged"])]
        log("[hf_serve] python -m repro_torch.launch.serve "
            + " ".join(argv_pre))
        reset_counts()
        run_pre = launcher.main(argv_pre)
        prefix_launches = launch_counts()
        log_time("hf_serve launcher with a shared prefix and --verify")
    finally:
        shutil.rmtree(HF_DIR, ignore_errors=True)
    eng = run.engine
    mcfg, layers = eng.cfg, eng.cfg.num_layers
    assert run1.engine.cfg.aqua.block_dims == 1
    assert len(run1.streamed) == 8 and run1.stats.tokens_emitted == 8 * 32
    want = dict.fromkeys(KERNELS, 0)
    want["flash_attention"] = layers * (
        run1.stats.admissions + run1.reference_stats.admissions
        + launcher.CALIBRATION_BATCHES)
    assert per_dim_launches == want, (per_dim_launches, want)
    # its logits against a plain drive, reported and not held to a limit:
    # per-dim selection ranks each query's dims, so the two drives' hidden
    # states can part where a rank is near a tie
    reqs1 = [dataclasses.replace(r) for r in run1.requests]
    ref1_eng = ContinuousBatchingEngine(run1.engine.cfg, run1.engine.params,
                                        run1.projections,
                                        serving=run1.engine.scfg,
                                        backend="aqua-block-sparse-plain")
    per_dim_vs_ref = compare_logits(
        serve_drive(run1.engine, reqs1),
        serve_drive(ref1_eng, [dataclasses.replace(r) for r in reqs1]), 32,
        per_element=True, check=False)
    per_dim = dict(wall_s=run1.seconds, tokens=run1.stats.tokens_emitted,
                   tokens_per_s=run1.stats.tokens_emitted / run1.seconds,
                   decode_steps=run1.stats.decode_steps,
                   admissions=run1.stats.admissions,
                   reference_admissions=run1.reference_stats.admissions,
                   launches_with_verify=per_dim_launches,
                   vs_plain_unscaled=per_dim_vs_ref)
    log(f"[hf_serve] block_dims 1: float32 logits over the unscaled limit "
        f"(F32_RTOL |want| + F32_ATOL) against a plain drive, not held: "
        f"admissions {per_dim_vs_ref['admit_worst_err_over_limit']}, decode "
        f"steps {per_dim_vs_ref['decode_worst_err_over_limit']}")
    del run1, ref1_eng
    pool = run_pre.engine.page_pool
    assert run_pre.engine.cfg.aqua.block_dims == 1
    assert (pool.prefix_hits, pool.tokens_saved) == (
        7, 7 * SHARED_PREFIX["prefix_paged"]), (pool.prefix_hits,
                                                pool.tokens_saved)
    assert len(run_pre.streamed) == 8 \
        and run_pre.stats.tokens_emitted == 8 * 32
    # flash once per layer per fresh admission (one), per admission of the
    # contiguous reference and per calibration batch; shared tails run
    # the reference chunk step and decode the masked-dense core
    want = dict.fromkeys(KERNELS, 0)
    want["flash_attention"] = layers * (
        run_pre.stats.admissions - pool.prefix_hits
        + run_pre.reference_stats.admissions + launcher.CALIBRATION_BATCHES)
    assert prefix_launches == want, (prefix_launches, want)
    st_pre = run_pre.stats
    shared_prefix = dict(
        prefix_hits=pool.prefix_hits, tokens_saved=pool.tokens_saved,
        peak_pages_in_use=pool.peak_in_use, wall_s=run_pre.seconds,
        tokens_per_s=st_pre.tokens_emitted / run_pre.seconds,
        admit_ms_shared=1e3 * st_pre.shared_admit_seconds / pool.prefix_hits,
        admit_ms_fresh=1e3 * (st_pre.admit_seconds
                              - st_pre.shared_admit_seconds)
        / (st_pre.admissions - pool.prefix_hits),
        itl_p99_ms=1e3 * st_pre.itl_percentile(99),
        launches_with_verify=prefix_launches)
    log(f"[hf_serve] shared prefix: {shared_prefix} on {card}")
    del run_pre
    gc.collect()
    torch.cuda.empty_cache()
    assert mcfg.dtype == mcfg.param_dtype == "float32", mcfg
    assert eng.paged and eng.step_graph is not None
    st = run.stats
    assert len(run.streamed) == 8 and st.tokens_emitted == 8 * 32
    # the launcher's run also holds its calibration forwards (one prefill
    # per layer each) and --verify's contiguous reference drive
    ref_st = run.reference_stats
    want = dict.fromkeys(KERNELS, 0)
    want["aqua_prefill"] = layers * (st.admissions + ref_st.admissions
                                     + launcher.CALIBRATION_BATCHES)
    want["aqua_paged_decode"] = layers * st.decode_steps
    want["aqua_decode"] = layers * ref_st.decode_steps
    assert main_launches == want, (main_launches, want)

    reqs = [dataclasses.replace(r) for r in run.requests]
    reset_counts()
    again = serve_drive(eng, reqs)
    launches = launch_counts()
    assert again["tokens"] == run.streamed, "second serve changed tokens"
    want = dict.fromkeys(KERNELS, 0)
    want["aqua_prefill"] = layers * again["admissions"]
    want["aqua_paged_decode"] = layers * again["decode_steps"]
    assert launches == want, (launches, want)
    log(f"[hf_serve] second serve: admission ms {again['admit_ms']:.3f} "
        f"(launcher's first serve: "
        f"{1e3 * st.admit_seconds / st.admissions:.3f}), gap p50/p99/max "
        f"{again['itl_p50_ms']:.1f}/{again['itl_p99_ms']:.1f}/"
        f"{again['max_itl_ms']:.1f} ms")
    log_time("hf_serve second serve")
    # its admission graphs against eager admissions, bit for bit, in float32
    admit_check = admit_graph_phase("hf_serve", eng)
    log({"admit_graph": admit_check})
    log_time("hf_serve admit graph")
    ref_eng = ContinuousBatchingEngine(mcfg, eng.params, run.projections,
                                       serving=eng.scfg,
                                       backend="aqua-block-sparse-plain")
    reset_counts()
    ref = serve_drive(ref_eng, [dataclasses.replace(r) for r in reqs])
    assert sum(launch_counts().values()) == 0
    vs_ref = compare_logits(again, ref, 32, per_element=True,
                            scale=HF_LOGIT_SCALE)
    del ref_eng
    log_time("hf_serve plain reference drive")
    # the control: attention at bf16 input precision must break the limit
    ctl_eng = ContinuousBatchingEngine(
        mcfg, eng.params, run.projections, serving=eng.scfg,
        backend=register_bf16_inputs_control())
    ctl = serve_drive(ctl_eng, [dataclasses.replace(r) for r in reqs])
    vs_ctl = compare_logits(ctl, ref, 32, per_element=True,
                            scale=HF_LOGIT_SCALE, check=False)
    del ctl_eng, ctl
    log(f"[hf_serve] float32 logits over the limit ({HF_LOGIT_SCALE} x "
        f"(F32_RTOL |want| + F32_ATOL)): kernel drive admissions "
        f"{vs_ref['admit_worst_err_over_limit']}, decode steps "
        f"{vs_ref['decode_worst_err_over_limit']}; bf16-input control "
        f"admissions {vs_ctl['admit_worst_err_over_limit']}, decode steps "
        f"{vs_ctl['decode_worst_err_over_limit']}")
    assert vs_ctl["admit_worst_err_over_limit"] > 1.0, vs_ctl
    log_time("hf_serve bf16-input control drive")
    # the launcher's step graph against eager decode_step at full width in
    # float32, bit for bit, and its device ms per replay
    graph_check = step_graph_phase("hf_serve", eng, [
        dataclasses.replace(r) for r in reqs])
    log({"step_graph": graph_check})
    log_time("hf_serve step graph")
    torch.cuda.empty_cache()
    # the float32 routes at the drives' shapes: the paged decode and the
    # reference engine's contiguous decode over its contexts (128-1056
    # tokens of a 2048-token table), its longest prompt's prefill and, for
    # block_dims 1, flash
    phases = [decode_phase(cfg.name, att.num_heads, att.num_kv_heads, paged,
                           gen, s=2048, len_range=(128, 1056),
                           form="served", dtype="float32")
              for paged in (True, False)]
    phases += [prefill_phase(cfg.name, att.num_heads, att.num_kv_heads, gen,
                            s=1024, form="served", dtype="float32"),
               flash_phase(cfg.name, att.num_heads, att.num_kv_heads, gen,
                           s=1024, form="served", dtype="float32")]
    for p in phases:
        log(p)
    assert all(p["ok"] for p in phases), phases
    assert all(p["route"] == "group_f32" for p in phases[:2]), phases[:2]
    log_time("hf_serve float32 kernel phases")
    log(f"[hf_serve] checkpoint {nbytes} bytes written in {write_s:.2f} s, "
        f"loaded in {run.load_seconds:.2f} s; tokens/s "
        f"{again['tokens_per_s']:.2f}, decode step ms "
        f"{again['decode_step_ms']:.3f}, ITL p50/p99/max "
        f"{1e3 * st.itl_percentile(50):.1f}/{1e3 * st.itl_percentile(99):.1f}"
        f"/{1e3 * st.max_itl:.1f} ms (launcher's drive), KV bytes "
        f"{eng.cache_bytes()} on {card}")
    result = dict(
        checkpoint=dict(bytes=nbytes, files=files, write_s=write_s,
                        load_s=run.load_seconds, dtype_stored="bfloat16",
                        params_dtype=mcfg.param_dtype),
        model=dict(name=mcfg.name, layers=layers, d_model=mcfg.d_model,
                   heads=mcfg.attention.num_heads,
                   kv_heads=mcfg.attention.num_kv_heads,
                   head_dim=mcfg.attention.head_dim, d_ff=mcfg.d_ff,
                   vocab=mcfg.vocab_size, tied=mcfg.tie_embeddings),
        launcher=dict(wall_s=run.seconds, tokens=st.tokens_emitted,
                      tokens_per_s=st.tokens_emitted / run.seconds,
                      decode_steps=st.decode_steps,
                      itl_p50_ms=1e3 * st.itl_percentile(50),
                      itl_p99_ms=1e3 * st.itl_percentile(99),
                      max_itl_ms=1e3 * st.max_itl,
                      launches_with_verify=main_launches),
        launcher_block_dims_1=per_dim,
        launcher_shared_prefix=shared_prefix,
        second_serve={k: v for k, v in again.items()
                      if k not in ("tokens", "admit_logits", "step_logits")},
        launches=launches, cache_bytes=eng.cache_bytes(),
        capture_ms=eng.step_graph.capture_ms,
        graph_pool_bytes=eng.step_graph.pool_bytes,
        reference="aqua-block-sparse-plain",
        reference_decode_step_ms=ref["decode_step_ms"],
        vs_reference=vs_ref, bf16_inputs_control=vs_ctl,
        step_graph=graph_check, admit_graph=admit_check,
        graphs=eng.graph_accounting(),
        f32_rtol=F32_RTOL, f32_atol=F32_ATOL, logit_scale=HF_LOGIT_SCALE)
    log({"hf_serve": result})
    # each float32 route's launches on its path: the paged decode's and the
    # prefill's in the second serve, the contiguous decode's in the
    # launcher's run (--verify's reference engine), flash's in the
    # block_dims 1 launcher run
    f32_launches = {"aqua_decode": main_launches["aqua_decode"],
                    "aqua_paged_decode": launches["aqua_paged_decode"],
                    "aqua_prefill": launches["aqua_prefill"],
                    "flash_attention": per_dim_launches["flash_attention"]}
    return dict(result, phases=phases, f32_launches=f32_launches)


# the training phase (7a): Qwen3-0.6B at its full width and depth through
# Trainer.run at JAX's CLI defaults (batch 8 of 64 tokens, lcg data,
# warmup 1), 10 steps
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 10, 8, 64
# its first step's bf16-compute gradients against a float32-compute step
# on the same params and batch: the loss within 1e-3 relative, every
# leaf's cosine at least 0.999 and the global norm within 1e-3 relative
# (each about 10x the sound readings on the H100: 6.8e-5, 0.99963 and
# 2.8e-5, PERF.md). The planted fault (each block's attention output
# detached, as an unguarded kernel's would be: zero gradients into q, k
# and v) must fail them; its forward is the sound one, so its cosine and
# norm fail, not its loss.
GRAD_LOSS_RTOL, GRAD_COS_MIN, GRAD_NORM_RTOL = 1e-3, 0.999, 1e-3
# the evaluation path (7b): JAX's bench model (benchmarks/common.py),
# trained on the copy task; its ppl over the copied half with AQUA off
# (JAX's eval_nll; the reference's rows read 1.0005 at k_ratio 0.5)
COPY_PPL_MAX = 1.01
# greedy tokens of the continuous-batching engine that continue the copy
COPY_MATCH_MIN = 0.9
# a checkpoint resume (4 steps, a save, a fresh Trainer that restores, 4
# more) against 8 straight steps: CUDA's embedding backward adds with
# atomics (no deterministic algorithms are asked for), so each loss within
# 1e-4 relative and the params within 1e-4 of their norm
RESUME_RTOL = 1e-4


def _detached_dense():
    """A ``dense`` backend whose output carries no gradient: what a kernel
    launched without the guard would give autograd."""
    from repro_torch.core import attention as attn

    def prefill(*args, **kw):
        out, weights = attn._dense_prefill(*args, **kw)
        return out.detach(), weights
    if "dense-detached" not in attn.available_backends():
        attn.register_backend(attn.AttentionBackend("dense-detached",
                                                    prefill))
    return "dense-detached"


def _with_backend(mcfg, backend: str):
    return dataclasses.replace(mcfg, attention=dataclasses.replace(
        mcfg.attention, backend=backend))


def grad_agreement(grads, want) -> dict:
    """Per-leaf cosines and the global norms of two gradient trees."""
    import torch
    from repro_torch import tree as tree_lib
    cos = {}
    for (k, g), w in zip(tree_lib.items(grads), tree_lib.leaves(want)):
        g, w = g.double().flatten(), w.double().flatten()
        den = g.norm() * w.norm()
        cos[k] = float(g @ w / den) if den > 0 else 0.0
    norm = lambda t: float(torch.sqrt(sum(  # noqa: E731
        x.double().square().sum() for x in tree_lib.leaves(t))))
    gn, wn = norm(grads), norm(want)
    worst = min(cos, key=cos.get)
    return dict(min_cosine=cos[worst], min_cosine_leaf=worst,
                global_norm=gn, reference_norm=wn,
                norm_rel_err=abs(gn - wn) / wn)


def qwen3_training(card: str) -> dict:
    """7a: Qwen3-0.6B trained TRAIN_STEPS steps at full width and depth
    (float32 params, bf16 compute, remat on) through ``Trainer.run``, the
    launch counters zeroed before and read after (the training forward
    runs no kernel: ``auto`` under grad is ``dense``); its step times,
    peak memory against the state reckoned from the shapes, the step's
    bounds; then the gradient agreement, its planted fault and the
    guard."""
    import gc
    import statistics
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import Trainer, loss_and_grads
    from repro_torch.models import build_model

    mcfg = get_config("qwen3-0.6b")
    assert mcfg.remat and mcfg.dtype == "bfloat16" \
        and mcfg.param_dtype == "float32", mcfg
    # JAX's CLI at --steps 10: warmup max(1, steps // 10)
    tcfg = TrainConfig(total_steps=TRAIN_STEPS, warmup_steps=1,
                       checkpoint_every=max(10, TRAIN_STEPS // 4))
    dcfg = DataConfig(vocab_size=mcfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    trainer = Trainer(mcfg, tcfg, dcfg)
    step_fn, times = trainer._step_fn, []

    # wall-clock ms a step, synchronized on both sides (the step is
    # host-bound: CUDA events around it read the same; train_profile.py
    # reads the device's busy time)
    def timed(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        return out
    trainer._step_fn = timed
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state, losses = trainer.run(TRAIN_STEPS, log_every=5)
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    assert not any(launches.values()), launches
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], \
        losses
    params = state.params
    n = sum(t.numel() for t in tree_lib.leaves(params))
    # float32 params, grads and both moments
    reckoned = 4 * n * 4
    # operations: every matrix product forward (2 per multiply-add), twice
    # that backward, remat's recompute of each block's forward, and the
    # attention's scores and P·V over all S keys (the dense reference)
    att = mcfg.attention
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_blocks = sum(t.numel() for t in tree_lib.leaves(params["layers"]))
    n_unembed = mcfg.vocab_size * mcfg.d_model
    attn_fwd = (4 * TRAIN_BATCH * TRAIN_SEQ ** 2 * att.num_heads
                * att.head_dim * mcfg.num_layers)
    fwd = 2 * tokens * (n_blocks + n_unembed) + attn_fwd
    ops = 3 * fwd + 2 * tokens * n_blocks + attn_fwd
    # bytes: the optimizer alone reads params, grads and moments and writes
    # params and moments, float32
    nbytes = 7 * 4 * n
    bms, by = bound(nbytes, ops)
    step_ms = statistics.median(times[1:])
    del trainer, state, params
    gc.collect()
    torch.cuda.empty_cache()

    # the gradient check on the first step's params and batch
    fresh = Trainer(mcfg, tcfg, dcfg)
    params = fresh.init_state(tcfg.seed).params
    batch = fresh.batch(0)
    l16, g16 = loss_and_grads(fresh.model, params, batch)
    m32 = build_model(dataclasses.replace(mcfg, dtype="float32"))
    l32, g32 = loss_and_grads(m32, params, batch)
    agree = grad_agreement(g16, g32)
    agree["loss"], agree["reference_loss"] = float(l16), float(l32)
    agree["loss_rel_err"] = abs(float(l16) - float(l32)) / abs(float(l32))
    del g16
    faulty = build_model(_with_backend(mcfg, _detached_dense()))
    lf, gf = loss_and_grads(faulty, params, batch)
    fault = grad_agreement(gf, g32)
    fault["loss_rel_err"] = abs(float(lf) - float(l32)) / abs(float(l32))
    del gf, g32

    def within(a):
        return (a["loss_rel_err"] <= GRAD_LOSS_RTOL
                and a["min_cosine"] >= GRAD_COS_MIN
                and a["norm_rel_err"] <= GRAD_NORM_RTOL)
    agree["ok"], fault["ok"] = within(agree), within(fault)
    assert agree["ok"], agree
    assert not fault["ok"], fault
    reset_counts()
    try:
        loss_and_grads(build_model(_with_backend(mcfg, "flash")), params,
                       batch)
        guard = "did not raise"
    except NotImplementedError as e:
        guard = str(e)
    assert guard != "did not raise" and "no reverse mode" in guard, guard
    assert not any(launch_counts().values()), launch_counts()
    del fresh, params, m32, faulty
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        card=card, model=mcfg.name, layers=mcfg.num_layers,
        d_model=mcfg.d_model, vocab=mcfg.vocab_size, params=n,
        param_dtype=mcfg.param_dtype, compute_dtype=mcfg.dtype,
        remat=mcfg.remat, batch=TRAIN_BATCH, seq=TRAIN_SEQ, data="lcg",
        steps=TRAIN_STEPS, losses=losses, run_s=run_s,
        step_wall_ms=step_ms, step_times_wall_ms=times,
        tokens_per_s=tokens / (step_ms / 1e3),
        peak_bytes=peak, reckoned_state_bytes=reckoned,
        flop_bound_ms=ops / BF16_OPS_PER_S * 1e3,
        byte_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_ms=bms,
        bound_by=by, ops=ops, optimizer_bytes=nbytes,
        launches=launches, grad_agreement=agree, planted_fault=fault,
        guard=guard, limits=dict(loss_rtol=GRAD_LOSS_RTOL,
                                 min_cosine=GRAD_COS_MIN,
                                 norm_rtol=GRAD_NORM_RTOL))


def eval_phase(card: str) -> dict:
    """7b: the evaluation path of ``benchmarks/common.py`` on the card. The
    bench model (reduced Qwen3-0.6B, vocab 128, d_model 96: 4 / 2 heads of
    24, float32) trained 400 steps on the copy task (no kernel launched),
    calibrated on ``calibration_batches``, then ``ServeEngine.score`` on
    4 held-out batches (seed0 50 000) with AQUA off and at k_ratio 0.75
    and 0.5 (block_dims 8): each score through the kernels (launch
    counters zeroed before, read after) against the same score through
    the plain backend (``dense``, flash's plain form, with AQUA off;
    ``aqua-block-sparse-plain`` with it), within the float32 limit; the
    copied half's ppl;
    the trained model's greedy tokens through the continuous-batching
    engine; a checkpoint resume against straight steps."""
    import gc
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.configs import AquaConfig, ServingConfig, reduced
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.calibration import calibrate, capture_forward
    from repro_torch.data.pipeline import (DataConfig, calibration_batches,
                                           make_batch)
    from repro_torch.launch.train import Trainer, to_device
    from repro_torch.models import build_model
    from repro_torch.models.layers import cross_entropy
    from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                     ServeEngine)

    cfg = reduced("qwen3-0.6b", vocab=128, d_model=96)
    assert cfg.dtype == "float32" and not cfg.remat
    dcfg = DataConfig(vocab_size=128, seq_len=64, global_batch=16,
                      kind="copy")
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=20, total_steps=400)
    reset_counts()
    t0 = time.perf_counter()
    state, losses = Trainer(cfg, tcfg, dcfg).run(400, log_every=100)
    train_s = time.perf_counter() - t0
    assert not any(launch_counts().values()), launch_counts()
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    params = state.params
    proj = calibrate(capture_forward(build_model(cfg)), params,
                     calibration_batches(cfg, num_batches=4, batch=4,
                                         seq=64), cfg)
    held = [make_batch(dcfg, 50_000 + i) for i in range(4)]
    rows, score_launches = [], {}
    for k in (None, 0.75, 0.5):
        ck = cfg if k is None else cfg.with_aqua(
            AquaConfig(k_ratio=k, block_dims=8))
        plain = "dense" if k is None else "aqua-block-sparse-plain"
        eng = ServeEngine(ck, params, proj, max_seq=64)
        ref = ServeEngine(ck, params, proj, max_seq=64, backend=plain)
        reset_counts()
        got = [float(eng.score(b)) for b in held]
        launches = launch_counts()
        want = [float(ref.score(b)) for b in held]
        err = max(abs(g - w) / (F32_RTOL * abs(w) + F32_ATOL)
                  for g, w in zip(got, want))
        copy_nll = []
        for b in held:
            b = to_device(b, eng.device)
            logits = eng.model.forward(eng.params, b, aqua_proj=eng.proj)
            copy_nll.append(float(cross_entropy(logits, b["labels"],
                                                b["loss_mask"])))
        kernel = "flash_attention" if k is None else "aqua_prefill"
        assert launches[kernel] > 0 and err <= 1.0, (k, launches, err)
        for name, n in launches.items():
            score_launches[name] = score_launches.get(name, 0) + n
        rows.append(dict(k_ratio=k, block_dims=None if k is None else 8,
                         ppl=math.exp(np.mean(got)),
                         plain_ppl=math.exp(np.mean(want)),
                         copy_ppl=math.exp(np.mean(copy_nll)),
                         scores=got, plain_scores=want,
                         worst_ratio_to_limit=err, kernel=kernel,
                         launches=launches[kernel], plain_backend=plain))
    assert rows[0]["copy_ppl"] <= COPY_PPL_MAX, rows[0]
    # greedy continuations of the copy through the continuous-batching
    # engine (k_ratio 0.5): a prompt of the prefix and 7 copied tokens,
    # 16 new tokens that should continue the copy
    c5 = cfg.with_aqua(AquaConfig(k_ratio=0.5, block_dims=8))
    cb = ContinuousBatchingEngine(c5, params, proj, serving=ServingConfig(
        max_lanes=4, max_seq=128, max_new_tokens=16))
    b = held[0]
    reqs = [Request(uid=i, tokens=b["tokens"][i, :40], max_new_tokens=16)
            for i in range(8)]
    reset_counts()
    outs = cb.run(reqs)
    cb_launches = launch_counts()
    target = b["labels"][:8, 39:55]
    match = float(np.mean([np.array(outs[i].tokens) == target[i]
                           for i in range(8)]))
    assert match >= COPY_MATCH_MIN and cb_launches["aqua_prefill"] > 0 \
        and cb_launches["aqua_paged_decode"] + cb_launches[
            "aqua_decode"] > 0, (match, cb_launches)
    # a checkpoint resume
    rt = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=8,
                     checkpoint_every=4)
    ck = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        s1, l1 = Trainer(cfg, rt, dcfg).run(8, log_every=100)
        _, l2 = Trainer(cfg, rt, dcfg, ckpt_dir=ck).run(4, log_every=100)
        saved = sorted(os.listdir(ck))
        s3, l3 = Trainer(cfg, rt, dcfg, ckpt_dir=ck).run(4, log_every=100)
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l2 + l3, l1))
    diff = torch.sqrt(sum((a - b).double().square().sum() for a, b in zip(
        tree_lib.leaves(s3.params), tree_lib.leaves(s1.params))))
    scale = torch.sqrt(sum(a.double().square().sum()
                           for a in tree_lib.leaves(s1.params)))
    param_err = float(diff / scale)
    resume = dict(steps=[4, 4], straight=8, saved=saved, losses=l2 + l3,
                  straight_losses=l1, loss_rel_err=loss_err,
                  param_rel_err=param_err, rtol=RESUME_RTOL,
                  deterministic_algorithms=False)
    assert int(s3.step) == 8 and loss_err <= RESUME_RTOL \
        and param_err <= RESUME_RTOL, resume
    del cb, state, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(card=card, model="reduced qwen3-0.6b (vocab 128, d_model 96)",
                heads=cfg.attention.num_heads,
                kv_heads=cfg.attention.num_kv_heads,
                head_dim=cfg.attention.head_dim, dtype=cfg.dtype,
                train_steps=400, train_s=train_s, first_loss=losses[0],
                last_loss=losses[-1], rows=rows,
                score_launches=score_launches, f32_rtol=F32_RTOL,
                f32_atol=F32_ATOL, copy_ppl_max=COPY_PPL_MAX,
                serve=dict(engine="ContinuousBatchingEngine", k_ratio=0.5,
                           requests=8, lanes=4, copy_match=match,
                           min_match=COPY_MATCH_MIN, launches=cb_launches),
                resume=resume)


MESH_SHAPE = (2, 2)
MESH_DIR = os.path.join(ROOT, "build", "mesh_phase")
MESH_SEED = 3
MESH_REQUESTS = 8


def nccl_probe_rank(out_dir: str) -> None:
    """One of two ranks on one card asking NCCL for a communicator and one
    all-reduce (spawned by ``mesh_phase``): writes what NCCL said, its
    error or "ok". Its subject is the error: the mesh's ranks share the
    card, so their collectives run over gloo."""
    import datetime
    import torch
    import torch.distributed as dist
    rank = int(os.environ["RANK"])
    wait = datetime.timedelta(seconds=60)
    store = dist.TCPStore("127.0.0.1", int(os.environ["MASTER_PORT"]), 2,
                          rank == 0, timeout=wait)
    torch.cuda.set_device(0)
    try:
        pg = dist.ProcessGroupNCCL(store, rank, 2)
        t = torch.ones(1, device="cuda")
        pg.allreduce([t]).wait(wait)
        torch.cuda.synchronize()
        said = "ok"
    except Exception as e:        # what NCCL says is what is recorded
        said = str(e)
    with open(os.path.join(out_dir, f"nccl{rank}.txt"), "w") as f:
        f.write(said)


def host_model(mesh, dtype: str) -> tuple:
    """Qwen3-0.6B at full width and depth with AQUA (K_RATIO, BLOCK_DIMS),
    its random weights of ``dtype`` from MESH_SEED made on the host (every
    rank makes the same: the CPU generator), so that each rank copies only
    its blocks to the card, as the launcher places them; projections
    calibrated on the host by rank 0 (32-token windows of the corpus) and
    given to every rank (``collectives.from_rank0``, on the card): (config,
    host params, projections)."""
    import torch
    from repro_torch.configs import AquaConfig, get_config
    from repro_torch.core.calibration import (AquaProjections, calibrate,
                                              capture_forward)
    from repro_torch.data.corpus import calibration_batches
    from repro_torch.distributed import collectives
    from repro_torch.models import build_model
    mcfg = dataclasses.replace(get_config("qwen3-0.6b"), dtype=dtype,
                               param_dtype=dtype).with_aqua(
        AquaConfig(k_ratio=K_RATIO, block_dims=BLOCK_DIMS))
    model = build_model(mcfg, "cpu")
    host = model.init(torch.Generator().manual_seed(MESH_SEED))
    a = mcfg.attention
    p = torch.zeros(mcfg.num_layers, a.num_kv_heads, a.head_dim, a.head_dim,
                    device=mesh.device)
    if mesh.rank == 0:
        p = calibrate(capture_forward(model), host, calibration_batches(
            mcfg.vocab_size, os.path.join(ROOT, "corpora",
                                          "calibration.txt"),
            num_batches=2, batch=2, seq=32, model_cfg=mcfg), mcfg,
            device=mesh.device).p
    return mcfg, host, AquaProjections(p=collectives.from_rank0(p, mesh))


def shard_kernel_checks(eng, serving, dtype: str, f32: bool) -> dict:
    """The prefill and the paged decode, each kernel's wrapper against its
    plain version on the card, at the shard-local shapes the mesh engine
    ``eng`` gives them (its heads and KV heads, its lanes, the trace's
    longest prompt and its contexts, 64-token pages; float32 with 8 shared
    pages, as prefix sharing maps them), each with its planted faults
    (``prefill_phase``, ``decode_phase``)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(MESH_SEED)
    a = eng.model.cfg.attention
    geom = f"mesh_2x2_rank_{a.num_heads}h_{a.num_kv_heads}kv"
    pre = SHARED_PREFIX["prefix_paged"]
    out = dict(
        aqua_prefill=prefill_phase(geom, a.num_heads, a.num_kv_heads, gen,
                                   s=pre + 1024, form="mesh_shard",
                                   dtype=dtype, d=a.head_dim),
        aqua_paged_decode=decode_phase(
            geom, a.num_heads, a.num_kv_heads, True, gen,
            s=serving.max_seq, len_range=(pre + 128, pre + 1024 + 32),
            form="mesh_shard", dtype=dtype, d=a.head_dim,
            shared_pages=pre // serving.cache.page_size if f32 else 0,
            b=eng._local_lanes))
    bad = [k for k, v in out.items() if not v["ok"]]
    assert not bad, f"{dtype}: at the mesh's shard-local shapes {bad} " \
        f"disagree with their plain versions: {out}"
    return out


def parted_rows(mcfg, ref_eng, reqs, run, ref) -> list:
    """Where the bf16 mesh drive's greedy tokens part from the single-device
    engine's: at each request's first parting token, the logits of a
    plain forward in float32 activations over the same bf16 weights and
    projections (as ``pixtral_divergence.py`` holds a parting), on the
    prompt and the tokens both drives agreed on. ``gap_over_limit``: the
    float32 logits of the two parting tokens apart, over the bf16 limit
    (LOGIT_RTOL of the row's largest magnitude); below 1 the two tokens
    are a near tie that any bf16 computation within the limit may break
    either way."""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    f32 = build_model(dataclasses.replace(
        mcfg, dtype="float32", attention=dataclasses.replace(
            mcfg.attention, backend="aqua-block-sparse-plain")), "cuda")
    rows = []
    for r in reqs:
        got, want = run["tokens"][r.uid], ref["tokens"][r.uid]
        j = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y),
                 None)
        if j is None:
            continue
        # the prompt and the agreed tokens, bucket-padded as the engine
        # pads an admission
        batch = ref_eng._prefill_batch(np.concatenate(
            [np.asarray(r.tokens, np.int32), np.asarray(want[:j], np.int32)]))
        batch.update(ref_eng._frontend_inputs(r))
        row = f32.prefill(ref_eng.params, batch, ref_eng.scfg.max_seq,
                          aqua_proj=ref_eng.proj)[0][0].float()
        limit = LOGIT_RTOL * row.abs().max().item()
        top2 = torch.topk(row, 2).values
        rows.append(dict(uid=r.uid, step=j, mesh_token=got[j],
                         single_device_token=want[j],
                         float32_argmax=int(row.argmax()),
                         gap_over_limit=abs(row[got[j]] - row[want[j]]).item()
                         / limit,
                         float32_top2_margin_over_limit=(
                             top2[0] - top2[1]).item() / limit,
                         near_tie=abs(row[got[j]] - row[want[j]]).item()
                         < limit))
    del f32
    return rows


def decode_selections(tape, mcfg, eng, lanes: int, heads: int):
    """(DECODE_STEPS_CHECKED, layers, lanes, heads, selected blocks) int32:
    the decode dim-block selections of a drive's checked steps, from the
    ``SelectionTape`` installed over its one serve on ``eng`` (one decode
    call a layer a step, nothing else in the drive selects per row; an
    engine that captured its step graph in that serve made one warm-up
    step first), on the tape's device."""
    import torch
    nsel = mcfg.aqua.topk_dims(mcfg.attention.head_dim) // \
        mcfg.aqua.block_dims
    first = mcfg.num_layers if eng.step_graph is not None else 0
    calls = first + DECODE_STEPS_CHECKED * mcfg.num_layers
    assert int(tape.calls[0]) >= calls and not tape.overflowed
    return tape.buf["decode"][first:calls, :lanes * heads * nsel].reshape(
        DECODE_STEPS_CHECKED, mcfg.num_layers, lanes, heads,
        nsel).to(torch.int32)


def mesh_drive(mesh, dtype: str) -> dict:
    """One drive of the mesh phase on this rank (module docstring, section
    7b): the prefix_paged trace on a 2x2 mesh engine over this rank's
    blocks (float32: prefix sharing on; bf16: off), every step's logits
    gathered over the data axes; the launches must be the path's exactly.
    Rank 0 then serves the trace on one device, with the kernels and with
    their plain versions, holds the mesh's logits to both by request,
    and holds the prefill and the paged decode to their plain versions
    at this rank's shard-local shapes; bf16 shows each parted row against
    a float32 forward (``parted_rows``). Bf16 also plants the swapped KV
    shard (``mesh_fault``) and serves the trace on a data-only 4x1 mesh
    of the same ranks (``data_only_drive``)."""
    import gc
    import torch
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import CacheSpec, ServingConfig
    from repro_torch.core.aqua import SelectionTape
    from repro_torch.distributed import collectives
    from repro_torch.serving import ContinuousBatchingEngine
    mcfg, host, proj = host_model(mesh, dtype)
    f32 = dtype == "float32"
    serving = ServingConfig(max_lanes=8, max_seq=2048, max_new_tokens=32,
                            cache=CacheSpec(page_size=64,
                                            prefix_sharing=f32))
    reqs = drive_trace(MESH_REQUESTS, mcfg.vocab_size,
                       shared_prefix=SHARED_PREFIX["prefix_paged"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousBatchingEngine(
        mcfg, params_from_numpy(host, mesh.device, mesh=mesh), proj,
        serving=serving, mesh=mesh)
    plan = eng.dispatch_plan()
    assert plan.mesh_native and plan.prefix_sharing == f32, plan
    assert eng.step_graph is None and not eng.uses_graphs

    def gather(t):
        return collectives.all_gather(t, mesh, mesh.data_axes)
    # float32 (held to one device per logit): every decode selection
    # recorded, whole over heads and lanes on rank 0
    tape = SelectionTape("cuda") if f32 else None
    if f32:
        tape.install("record")
    reset_counts()
    run = serve_drive(eng, [dataclasses.replace(r) for r in reqs],
                      gather=gather)
    launches = launch_counts()
    sel = None
    if f32:
        tape.remove()
        a = eng.model.cfg.attention
        sel = gather(collectives.all_gather(decode_selections(
            tape, mcfg, eng, eng._local_lanes, a.num_heads), mesh, "model",
            dim=3).transpose(0, 2).contiguous()).transpose(0, 2).cpu()
    layers = mcfg.num_layers
    fresh = run["admissions"] - eng.page_pool.prefix_hits
    want = dict.fromkeys(KERNELS, 0)
    want.update(aqua_prefill=layers * fresh,
                aqua_paged_decode=layers * run["decode_steps"])
    assert launches == want, (mesh.rank, launches, want)
    assert eng.mesh_fallback_events() == (), eng.mesh_fallback_events()
    assert eng.step_graph is None
    out = dict(
        plan=dict(backend=plan.backend, layout=plan.cache_layout,
                  mesh_native=plan.mesh_native,
                  prefix_sharing=plan.prefix_sharing),
        tokens={str(u): t for u, t in run["tokens"].items()},
        launches=launches, launches_expected=want,
        admissions=run["admissions"],
        prefix_hits=eng.page_pool.prefix_hits,
        decode_steps=run["decode_steps"],
        decode_step_ms=run["decode_step_ms"], admit_ms=run["admit_ms"],
        tokens_per_s=run["tokens_per_s"], wall_s=run["wall_s"],
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        rank_kv_cache_bytes=eng.rank_cache_bytes(),
        kv_cache_bytes=eng.cache_bytes(),
        rank_param_bytes=sum(t.numel() * t.element_size()
                             for t in _leaves(eng.params)),
        step_graph=None, fallback_events=[])
    ref = None
    if mesh.rank == 0:
        out["shard_kernels"] = shard_kernel_checks(eng, serving, dtype, f32)
    del eng
    gc.collect()
    if mesh.rank == 0:
        whole = params_from_numpy(host, "cuda")
        sels = {}

        def single(backend):
            """The trace on one device (``backend``), float32 recording
            its decode selections; returns the engine, the drive and the
            tape (which its graphs write: it must outlive them)."""
            t = SelectionTape("cuda") if f32 else None
            if f32:
                t.install("record")
            e = ContinuousBatchingEngine(mcfg, whole, proj, serving=serving,
                                         backend=backend)
            r = serve_drive(e, [dataclasses.replace(q) for q in reqs])
            if f32:
                t.remove()
                sels[backend] = decode_selections(
                    t, mcfg, e, serving.max_lanes,
                    mcfg.attention.num_heads).cpu()
            return e, r, t
        ref_eng, ref, ref_tape = single("aqua-block-sparse")
        plain_eng, plain, plain_tape = single("aqua-block-sparse-plain")
        del plain_eng, plain_tape
        out["reference"] = dict(tokens_per_s=ref["tokens_per_s"],
                                decode_step_ms=ref["decode_step_ms"],
                                step_graph=ref_eng.step_graph is not None)
        kw = dict(per_element=f32, scale=HF_LOGIT_SCALE, by_uid=True)
        out["vs_single_device"] = compare_logits(
            run, ref, 32, **kw, selections=None if not f32 else (
                sel, sels["aqua-block-sparse"]))
        out["vs_single_device_plain"] = compare_logits(
            run, plain, 32, **kw, selections=None if not f32 else (
                sel, sels["aqua-block-sparse-plain"]))
        if f32:
            assert run["tokens"] == ref["tokens"], "float32 mesh tokens"
            # the same comparison between the two one-device drives: their
            # selections part at near ties too
            out["single_device_kernel_vs_plain"] = compare_logits(
                ref, plain, 32, per_element=True, scale=HF_LOGIT_SCALE,
                selections=(sels["aqua-block-sparse"],
                            sels["aqua-block-sparse-plain"]))
        else:
            out["parted_rows"] = parted_rows(mcfg, ref_eng, reqs, run, ref)
        del ref_eng, ref_tape, whole
        gc.collect()
        torch.cuda.empty_cache()
    if not f32:
        out["fault"] = mesh_fault(mesh, mcfg, host, proj, serving, reqs,
                                  ref)
        out["data_only"] = data_only_drive(mesh, mcfg, host, proj, serving,
                                           reqs, ref)
    del run, ref, host
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def mesh_fault(mesh, mcfg, host, proj, serving, reqs, ref) -> dict:
    """The planted fault: every rank's KV shard (``wk``, ``wv``) swapped for
    its model peer's; two admissions (one token each) whose logits rank 0
    holds to the reference drive's: the worst row must break the limit."""
    import torch
    from repro_torch.bridge import params_from_numpy
    from repro_torch.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(
        mcfg, params_from_numpy(host, mesh.device, mesh=mesh), proj,
        serving=serving, mesh=mesh)
    attn = eng.params["layers"]["attn"]
    r = mesh.axis_index("model")
    for key in ("wk", "wv"):
        n = attn[key].shape[2]
        attn[key].copy_(host["layers"]["attn"][key][
            :, :, (1 - r) * n:(2 - r) * n])
    fault = serve_drive(eng, [dataclasses.replace(q, max_new_tokens=1)
                              for q in reqs[:2]])
    del eng
    if ref is None:
        return {}
    worst = max(((fault["admit_logits"][u] - want).abs().max()
                 / (LOGIT_RTOL * want.abs().max())).item()
                for u, want in ref["admit_logits"].items()
                if u in fault["admit_logits"])
    assert worst > 1.0, f"the swapped KV shard passed the limit: {worst}"
    return dict(kind="KV shard swapped across the model axis",
                admissions=len(fault["admit_logits"]),
                worst_err_over_limit=worst)


def data_only_drive(mesh, mcfg, host, proj, serving, reqs, ref) -> dict:
    """The bf16 trace on a data-only 4x1 mesh of the same four ranks (no
    collective inside the step or the admission, so the engine captures
    its step graph and its admission graphs: the owner replays its
    admissions, every other rank grafts them eagerly into its replica of
    the pool; the sampled tokens are all-gathered over ``data``). Every
    rank holds the whole weights. The launches must be the path's; rank
    0 holds the logits to the single-device engine's (``ref``) by
    request."""
    import torch
    from repro_torch.bridge import params_from_numpy
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import SERVING_AXES, Mesh
    from repro_torch.serving import ContinuousBatchingEngine
    import torch.distributed as dist
    data = Mesh((mesh.size, 1), SERVING_AXES, mesh.rank,
                dist.PrefixStore("data_only", mesh.store),
                backend=mesh.backend, device=mesh.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousBatchingEngine(
        mcfg, params_from_numpy(host, data.device, mesh=data), proj,
        serving=serving, mesh=data)
    plan = eng.dispatch_plan()
    assert plan.mesh_native and eng.uses_graphs, plan
    reset_counts()
    run = serve_drive(eng, [dataclasses.replace(r) for r in reqs],
                      gather=lambda t: collectives.all_gather(
                          t, data, data.data_axes))
    launches = launch_counts()
    want = dict.fromkeys(KERNELS, 0)
    want.update(aqua_prefill=mcfg.num_layers * run["admissions"],
                aqua_paged_decode=mcfg.num_layers * run["decode_steps"])
    assert launches == want, (mesh.rank, launches, want)
    assert eng.step_graph is not None and eng.admit_graphs, \
        "the data-only mesh captured no graph"
    assert eng.mesh_fallback_events() == ()
    out = dict(shape=f"{mesh.size}x1", tokens={str(u): t for u, t in
                                              run["tokens"].items()},
               launches=launches, launches_expected=want,
               admissions=run["admissions"],
               decode_steps=run["decode_steps"],
               decode_step_ms=run["decode_step_ms"],
               admit_ms=run["admit_ms"], tokens_per_s=run["tokens_per_s"],
               step_graph=True, admit_graph_buckets=sorted(eng.admit_graphs),
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    del eng
    if ref is not None:
        out["vs_single_device"] = compare_logits(run, ref, 32, by_uid=True)
    return out


#: this slice's drives on the 2x2 mesh (module docstring, section 7c):
#: (drive, config, weight seed, layers (None: uncut), lanes, prompt
#: lengths, max_seq, KV dtype, hot-resident fraction, page_keep_ratio,
#: calibration window). Qwen3-0.6B's weights are the single-device drives'
#: (seed 0), Danube's (seed 1), OLMoE's (seed 4) and Pixtral's (seed 6)
#: too; hierarchical int8 (a kernel form no other drive here launches) and
#: Pixtral-12B run at a cut depth: Pixtral's four ranks' blocks, its
#: whole weights on rank 0 for the single-device references and one
#: rank's transient whole copy at placement would not fit the card at 40
#: layers.
MESH_POLICY_DRIVES = (
    ("int8", "qwen3-0.6b", 0, None, 8, (128, 512, 1024), 2048, "int8", 0.0,
     1.0, 32),
    ("hot_int8", "qwen3-0.6b", 0, None, 8, (128, 512, 1024), 2048, "int8",
     0.25, 1.0, 32),
    ("hier_int8", "qwen3-0.6b", 0, 8, 8, (512, 1024), 2048, "int8", 0.0,
     0.25, 32),
    ("window", "h2o-danube-1.8b", 1, None, 4, (4160, 4480, 4800, 5120), 8192,
     "bf16", 0.0, 1.0, 32),
    ("moe", "olmoe-1b-7b", 4, None, 8, (121, 509, 1003), 2048, "bf16", 0.0,
     1.0, 32),
    ("vlm", "pixtral-12b", 6, 10, 4, (300, 700, 1000), 2048, "bf16", 0.0,
     1.0, 320),
)
#: requests, new tokens each and mean arrival gap (decode steps) of a
#: policy drive's trace: about 24 decode steps, 16 of them checked
MESH_POLICY_REQUESTS, MESH_POLICY_NEW, MESH_POLICY_GAP = 4, 16, 2.0
#: the policy drives whose single-device references replay the mesh's
#: dim-block selections (``core.aqua.SelectionTape``) and, for the MoE,
#: its routing (``models.moe.RoutingTape``): in bf16 at OLMoE's and
#: Pixtral's width a rank's other reduction order ranks near-tied
#: blocks of |q̂| (and near-tied experts) the other way in some layer and
#: head of nearly every lane (OLMoE on the H100: 11 of 16 layers apart at
#: a lane's first step; every admission routed apart), as Pixtral's two
#: one-device drives part; the self-selecting kernel drive is reported
#: beside
MESH_POLICY_SELECTING = ("moe", "vlm")
#: the kernel a policy drive launches once a layer a decode step (None:
#: decode on the masked-dense core, as in JAX)
MESH_POLICY_STEP_KERNEL = {
    "int8": "aqua_paged_quant_decode", "hot_int8": None,
    "hier_int8": "aqua_paged_part_quant_decode", "window": None,
    "moe": "aqua_paged_decode", "vlm": "aqua_paged_decode"}


def mesh_policy_plan(name: str) -> dict:
    """The JAX package's plan of a policy drive on 2x2, as
    ``tests/test_torch_mesh_policies.py`` and
    ``tests/test_torch_mesh_families.py`` hold the port's to it: int8
    pools without residents serve the kernels on shard-local shapes, hot
    residents and the window keep decode on the reference core, with
    JAX's reasons."""
    from repro_torch.core import dispatch as d
    native = dict(mesh_native=True, reasons=(), quantization="none",
                  token_sparsity="none")
    return dict(
        int8=dict(native, quantization="int8"),
        hot_int8=dict(native, mesh_native=False,
                      reasons=(d.REASON_QUANT_RESIDENCY,),
                      quantization="int8-mixed"),
        hier_int8=dict(native, quantization="int8",
                       token_sparsity="hierarchical"),
        window=dict(native, mesh_native=False, reasons=(d.REASON_WINDOW,)),
        moe=native, vlm=native)[name]


def mesh_barrier(mesh) -> None:
    """Every rank of the mesh reaches this point (an all-reduce over each
    axis)."""
    import torch
    from repro_torch.distributed import collectives
    collectives.all_reduce(torch.zeros(1, device=mesh.device), mesh,
                           mesh.axes)


def mesh_model(mesh, name: str, seed: int, layers, calib: int) -> tuple:
    """A policy drive's model on this rank: the ranks take turns to make
    the whole model on the card from ``seed`` (``load_model``'s weights,
    the single-device drives' own), keep their blocks
    (``bridge.params_from_numpy(mesh=)``) and free the whole, so the card
    holds one whole copy at a time; rank 0 calibrates the projections on
    it and every rank takes rank 0's (``collectives.from_rank0``): (config,
    the rank's params, projections)."""
    import gc
    import torch
    from repro_torch.bridge import params_from_numpy
    from repro_torch.core.calibration import AquaProjections
    from repro_torch.distributed import collectives
    from repro_torch.models.layers import UNEMBED_F32
    mcfg = drive_config(name, layers=layers)
    a = mcfg.attention
    mine, p = None, torch.zeros(mcfg.num_layers, a.num_kv_heads, a.head_dim,
                                a.head_dim, device=mesh.device)
    for turn in range(mesh.size):
        mesh_barrier(mesh)
        if mesh.rank != turn:
            continue
        _, whole, proj = load_model(name, seed, calib_seq=calib,
                                    layers=layers,
                                    calibrate_proj=mesh.rank == 0)
        whole.pop(UNEMBED_F32)
        mine = params_from_numpy(whole, mesh.device, mesh=mesh)
        if proj is not None:
            p = proj.p
        del whole, proj
        gc.collect()
        torch.cuda.empty_cache()
    mesh_barrier(mesh)
    return mcfg, mine, AquaProjections(p=collectives.from_rank0(p, mesh))


def scale_swap_fault(mesh, mcfg, mine, proj, serving, reqs) -> dict:
    """The planted fault of the int8 drive: two of its requests, both
    arriving at once with 4 new tokens, served twice on the mesh: clean,
    and with every rank's page scales (``k_scale``, ``v_scale``) swapped
    for its model peer's once both are admitted. Rank 0 holds the faulty
    decode steps' logits of both lanes to the clean drive's at LOGIT_RTOL:
    the worst row must break the limit."""
    from repro_torch.distributed import collectives
    from repro_torch.serving import ContinuousBatchingEngine
    rs = [dataclasses.replace(r, arrival=0.0, max_new_tokens=4)
          for r in reqs[:2]]
    uids = {r.uid for r in rs}

    def drive(swap: bool) -> list:
        eng = ContinuousBatchingEngine(mcfg, mine, proj, serving=serving,
                                       mesh=mesh)
        steps, admitted = [], 0
        for ev in eng.serve([dataclasses.replace(r) for r in rs]):
            if ev.index == 0:
                admitted += 1
                if swap and admitted == len(rs):
                    st, m = eng.last_state.layers, mesh.axis_index("model")
                    n = st.k_scale.shape[0]
                    for t in (st.k_scale, st.v_scale):
                        both = collectives.all_gather(t, mesh, "model",
                                                      dim=0)
                        t.copy_(both[(1 - m) * n:(2 - m) * n])
            elif eng.stats.decode_steps > len(steps):
                logits = collectives.all_gather(eng.last_step_logits, mesh,
                                                mesh.data_axes)
                # the two requests' lanes (the last step retires both)
                lanes = [i for i, u in enumerate(eng.last_lanes.uid)
                         if int(u) in uids]
                steps.append(logits[lanes].float().clone())
        del eng
        return steps
    clean, faulty = drive(False), drive(True)
    assert len(clean) == len(faulty) > 0
    worst = max(((f - c).abs().amax(dim=-1)
                 / (LOGIT_RTOL * c.abs().amax(dim=-1))).max().item()
                for f, c in zip(faulty, clean))
    assert worst > 1.0, f"the swapped page scales passed the limit: {worst}"
    return dict(kind="int8 page scales swapped across the model axis",
                decode_steps=len(clean), worst_err_over_limit=worst)


def policy_shard_kernels(name: str, eng, prompts) -> list:
    """The kernels of a policy drive's path at the shard-local shapes its
    2x2 engine ``eng`` gives them, each against its plain version with its
    planted faults: the int8 paged decode (4 lanes, 8 heads over 4 KV
    heads) with scales per page and KV head and with one per page; the
    int8 decode over participating pages; the prefill's window form at a
    Danube rank's 16 heads over 4 KV heads of 80 dims; the paged decode
    and the prefill at an OLMoE rank's 8 heads over 8 KV heads (group 1)
    and a Pixtral rank's 16 over 4, the admissions bucket-padded."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(MESH_SEED)
    a = eng.model.cfg.attention
    h, kvh, b = a.num_heads, a.num_kv_heads, eng._local_lanes
    geom = f"mesh_2x2_{name}_rank_{h}h_{kvh}kv"
    ctx = (min(prompts) + 1, max(prompts) + MESH_POLICY_NEW)
    s = eng.scfg.max_seq
    if name == "int8":
        return [paged_variant_phase(geom, h, kvh, True, False, gen, s=s,
                                    len_range=ctx, form="mesh_shard", b=b,
                                    granularity=g)
                for g in ("page_head", "page")]
    if name == "hier_int8":
        return [paged_variant_phase(geom, h, kvh, True, True, gen, s=s,
                                    len_range=ctx, form="mesh_shard", b=b)]
    if name == "window":
        return [dict(prefill_window_phase(geom, h, kvh, a.head_dim, gen,
                                          s=max(prompts),
                                          window=a.window),
                     form="mesh_shard_window")]
    if name in ("moe", "vlm"):
        longest = eng._padded_prompt_len(max(prompts))
        return [decode_phase(geom, h, kvh, True, gen, s=s, len_range=ctx,
                             form="mesh_shard", d=a.head_dim, b=b),
                prefill_phase(geom, h, kvh, gen, s=longest,
                              form="mesh_shard", d=a.head_dim,
                              pad=longest - max(prompts))]
    return []


def copied_tape(tape, mcfg, router, lanes: int, rows: int, warmup: bool):
    """A ``RoutingTape`` over ``router`` (a single-device model's stacked
    router) holding ``tape``'s recording, to replay it call for call.
    ``warmup``: the replaying engine captures its step graph in the serve,
    after one eager warm-up step, which takes the first decode call: the
    recording's decode calls move one call on."""
    from repro_torch.models import moe
    out = moe.RoutingTape(mcfg, router, lanes, rows)
    for d in (True, False):
        skip = mcfg.num_layers if d and warmup else 0
        for name in ("topi", "kept", "n"):
            dst, src = getattr(out, name)[d], getattr(tape, name)[d]
            dst[skip:].copy_(src[:src.shape[0] - skip])
    return out


def selection_tape(mcfg, lanes: int, heads: int):
    """A ``SelectionTape`` on the card sized for ``lanes`` x ``heads``
    decode rows (and a prefill's every head and tile)."""
    from repro_torch.core.aqua import SelectionTape
    return SelectionTape("cuda", slots=(8192, 1024),
                         numel=(lanes * heads * 16, 4096))


def gathered_selections(tape, mesh, lanes: int, heads: int, nsel: int):
    """A mesh rank's recorded selections (``tape``: its heads and lanes)
    put together into one device's, call for call, on rank 0 (None on
    the others): {stream: [each call's indices, flat, every head (and,
    decode, every lane) in one device's order]}. Every rank made the same
    calls; the heads are gathered over ``model``, a decode call's lanes
    over the data axes."""
    import torch
    from repro_torch.distributed import collectives
    parts = {}
    for c, stream in enumerate(tape.STREAMS):
        calls = min(int(tape.calls[c]), tape.buf[stream].shape[0])
        buf = tape.buf[stream][:calls].to(torch.int32).contiguous()
        n = tape.n[stream][:calls, None].contiguous()
        axes = ("model",) + (mesh.data_axes if stream == "decode" else ())
        for axis in axes:
            buf = collectives.all_gather(buf, mesh, axis, dim=1)
            n = collectives.all_gather(n, mesh, axis, dim=1)
        parts[stream] = (buf.cpu(), n.cpu())
    if mesh.rank != 0:
        return None
    m, d = mesh.axis_size("model"), mesh.data_size()
    out = {}
    for stream, (buf, n) in parts.items():
        ranks = m * (d if stream == "decode" else 1)
        width = buf.shape[1] // ranks
        rows = []
        for row, counts in zip(buf, n):
            blocks = [row[r * width:r * width + int(counts[r])]
                      for r in range(ranks)]
            if stream == "decode":        # (lanes, heads, nsel) a rank
                per = [torch.cat([b.view(lanes, heads, nsel)
                                  for b in blocks[i * m:(i + 1) * m]], 1)
                       for i in range(d)]
                rows.append(torch.cat(per, 0).reshape(-1))
            else:                         # (1, heads, tiles, nsel) a rank
                rows.append(torch.cat([b.view(1, heads, -1, nsel)
                                       for b in blocks], 1).reshape(-1))
        out[stream] = rows
    return out


def replayed_selections(mcfg, lanes: int, calls: dict, warmup: bool):
    """A ``SelectionTape`` installed to replay ``calls``
    (``gathered_selections``) on one device of ``lanes`` lanes. ``warmup``:
    the engine captures its step graph after one eager warm-up step,
    which takes the first decode call of each layer: the recording's
    decode calls move on by a step."""
    t = selection_tape(mcfg, lanes, mcfg.attention.num_heads)
    for stream, rows in calls.items():
        first = mcfg.num_layers if stream == "decode" and warmup else 0
        for i, flat in enumerate(rows):
            t.buf[stream][first + i, :flat.numel()] = flat.to(
                t.buf[stream].device)
    t.install("replay")
    return t


def policy_references(spec, mcfg, proj, serving, reqs, run, lane_order,
                      tape, sel) -> dict:
    """Rank 0's references of a policy drive: the whole weights made
    again from the seed, the trace served on one device (the mesh
    engine's lane order, so that an MoE's decode blocks hold the same
    lanes in the same order) with the kernels and with their plain
    versions, the mesh's logits held to both by request at LOGIT_RTOL.
    ``sel`` (``MESH_POLICY_SELECTING``): the mesh's selections put
    together (``gathered_selections``); both references replay them and
    an MoE's routing (``tape``), so that they part from the mesh only by
    rounding, and a third, self-selecting (and self-routed) kernel drive
    is reported beside, a row compared up to its first other route or
    selection (the excluded rows counted). Each request whose tokens part
    from the single-device kernel drive's is shown against a
    float32-activation forward at the parting token (``parted_rows``)."""
    import gc
    import torch
    from repro_torch.models import moe
    from repro_torch.serving import ContinuousBatchingEngine
    name, arch, seed, layers = spec[:4]
    calib = spec[-1]
    _, whole, _ = load_model(arch, seed, calib_seq=calib, layers=layers,
                             calibrate_proj=False)
    routed = mcfg.family == "moe"
    heads = mcfg.attention.num_heads
    drives, keep = {}, []
    kinds = [("aqua-block-sparse", sel is not None),
             ("aqua-block-sparse-plain", sel is not None)]
    if sel is not None:
        kinds.append(("aqua-block-sparse", False))
    for backend, replay in kinds:
        e = ContinuousBatchingEngine(mcfg, whole, proj, serving=serving,
                                     backend=backend)
        e._lane_order = list(lane_order) if lane_order else None
        rt = st = None
        if routed:
            router = whole["layers"]["ffn"]["router"]
            if replay:
                rt = copied_tape(tape, mcfg, router, serving.max_lanes,
                                 serving.max_seq, e.uses_graphs)
                rt.install("replay")
            else:
                rt = moe.RoutingTape(mcfg, router, serving.max_lanes,
                                     serving.max_seq)
                rt.install("record")
        if sel is not None:
            if replay:
                st = replayed_selections(mcfg, serving.max_lanes, sel,
                                         e.uses_graphs)
            else:
                st = selection_tape(mcfg, serving.max_lanes, heads)
                st.install("record")
        reset_counts()
        r = serve_drive(e, [dataclasses.replace(q) for q in reqs], tape=rt)
        for t in (rt, st):
            if t is not None:
                t.remove()
        if st is not None:
            assert not st.overflowed
            r["selections"] = decode_selections(st, mcfg, e,
                                                serving.max_lanes, heads)
        r["launches"] = launch_counts()
        r["step_graph"] = e.step_graph is not None
        drives[(backend, replay)] = (r, e)
        keep.append((rt, st))           # the engines' graphs write them
    key = (lambda b: (b, sel is not None))
    ref, ref_eng = drives[key("aqua-block-sparse")]
    plain = drives[key("aqua-block-sparse-plain")][0]
    assert sum(plain["launches"].values()) == 0, plain["launches"]
    held = dict(by_uid=True, routed=False if routed else None)
    out = dict(
        reference=dict(tokens_per_s=ref["tokens_per_s"],
                       decode_step_ms=ref["decode_step_ms"],
                       admit_ms=ref["admit_ms"],
                       step_graph=ref["step_graph"],
                       replays_mesh_selections=sel is not None,
                       replays_mesh_routing=routed),
        vs_single_device=compare_logits(run, ref, MESH_POLICY_NEW, **held),
        vs_single_device_plain=compare_logits(run, plain, MESH_POLICY_NEW,
                                              **held),
        single_device_kernel_vs_plain=compare_logits(
            ref, plain, MESH_POLICY_NEW, check=False, **held),
        parted_rows=parted_rows(mcfg, ref_eng, reqs, run, ref))
    assert all(out[k]["decode_rows_compared"] > 0 for k in (
        "vs_single_device", "vs_single_device_plain")), out
    if sel is not None:
        own = drives[("aqua-block-sparse", False)][0]
        mesh_sel = torch.stack(sel["decode"][:DECODE_STEPS_CHECKED
                                             * mcfg.num_layers]).view(
            DECODE_STEPS_CHECKED, mcfg.num_layers, serving.max_lanes,
            heads, -1)
        out["vs_single_device_self_selecting"] = compare_logits(
            run, own, MESH_POLICY_NEW, check=False, by_uid=True,
            routed=routed,
            selections=(mesh_sel, own["selections"].cpu()))
        if routed:
            out["single_device_drops"] = routing_drops(own, reqs, mcfg)
    del drives, keep, ref_eng, whole
    gc.collect()
    torch.cuda.empty_cache()
    return out


def policy_mesh_drive(mesh, spec) -> dict:
    """One drive of section 7c on this rank (``MESH_POLICY_DRIVES``): its
    model's blocks (``mesh_model``), a 2x2 engine on 64-token pages whose
    plan must be JAX's (``mesh_policy_plan``) and whose steps are eager,
    the trace (``MESH_POLICY_REQUESTS`` requests of ``MESH_POLICY_NEW``
    tokens, a frontend's own stub inputs each) with the counters zeroed
    just before and read just after: the prefill once a layer an
    admission (every data rank writes the pool), the drive's decode
    kernel once a layer a step
    (``MESH_POLICY_STEP_KERNEL``), nothing else; the fallback events JAX
    records (hot residents: ``REASON_QUANT_RESIDENCY``). An MoE drive
    records its routing on this rank's ``RoutingTape`` (every lane of a
    step routed as one block). Rank 0 then holds the mesh to the
    single-device engines (``policy_references``) and the drive's kernels
    to their plain versions at the rank's shapes
    (``policy_shard_kernels``); the int8 drive plants its fault
    (``scale_swap_fault``) on every rank."""
    import gc
    import torch
    from repro_torch.configs import (CacheSpec, QuantSpec, ServingConfig,
                                     SparsitySpec)
    from repro_torch.distributed import collectives
    from repro_torch.models import moe
    from repro_torch.serving import ContinuousBatchingEngine
    (name, arch, seed, layers, lanes, prompts, max_seq, kv, hot, keep,
     calib) = spec
    t0 = time.perf_counter()
    mcfg, mine, proj = mesh_model(mesh, arch, seed, layers, calib)
    setup_s = time.perf_counter() - t0
    serving = ServingConfig(
        max_lanes=lanes, max_seq=max_seq, max_new_tokens=MESH_POLICY_NEW,
        cache=CacheSpec(page_size=64, prefix_sharing=False),
        quant=QuantSpec(kv_dtype=kv, hot_resident_fraction=hot),
        sparsity=SparsitySpec(page_keep_ratio=keep) if keep < 1.0 else None)
    reqs = drive_trace(MESH_POLICY_REQUESTS, mcfg.vocab_size, prompts,
                       mcfg=mcfg, max_new=MESH_POLICY_NEW,
                       interarrival=MESH_POLICY_GAP)
    eng = ContinuousBatchingEngine(mcfg, mine, proj, serving=serving,
                                   mesh=mesh)
    plan = eng.dispatch_plan()
    got = dict(mesh_native=plan.mesh_native, reasons=plan.reasons,
               quantization=plan.quantization,
               token_sparsity=plan.token_sparsity)
    assert got == mesh_policy_plan(name), (name, got)
    assert eng.step_graph is None and not eng.uses_graphs
    tape = None
    if mcfg.family == "moe":
        tape = moe.RoutingTape(mcfg, eng.params["layers"]["ffn"]["router"],
                               lanes, max_seq, mesh=mesh)
        tape.install("record")
    a = eng.model.cfg.attention
    stape = None
    if name in MESH_POLICY_SELECTING:
        stape = selection_tape(mcfg, eng._local_lanes, a.num_heads)
        stape.install("record")

    def gather(t):
        return collectives.all_gather(t, mesh, mesh.data_axes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run = serve_drive(eng, [dataclasses.replace(r) for r in reqs],
                      tape=tape, gather=gather)
    launches = launch_counts()
    if tape is not None:
        tape.remove()
    sel = None
    if stape is not None:
        # every call's selections, every lane's and head's, as one device
        # makes them (on rank 0)
        stape.remove()
        assert not stape.overflowed
        sel = gathered_selections(
            stape, mesh, eng._local_lanes, a.num_heads,
            mcfg.aqua.topk_dims(a.head_dim) // mcfg.aqua.block_dims)
    want = dict.fromkeys(KERNELS, 0)
    want["aqua_prefill"] = mcfg.num_layers * run["admissions"]
    if MESH_POLICY_STEP_KERNEL[name] is not None:
        want[MESH_POLICY_STEP_KERNEL[name]] = \
            mcfg.num_layers * run["decode_steps"]
    assert launches == want, (name, mesh.rank, launches, want)
    events = eng.mesh_fallback_events()
    want_events = (((plan.backend, "decode", plan.reasons[0]),)
                   if name == "hot_int8" else ())
    assert events == want_events, (name, events)
    layout = eng.layout
    out = dict(
        setup_s=setup_s, layers=mcfg.num_layers,
        layers_cut_from=None if layers is None else drive_config(
            arch).num_layers,
        plan=dict(got, backend=plan.backend, layout=plan.cache_layout),
        fallback_events=[list(e) for e in events],
        tokens={str(u): t for u, t in run["tokens"].items()},
        launches=launches, launches_expected=want,
        admissions=run["admissions"], decode_steps=run["decode_steps"],
        decode_step_ms=run["decode_step_ms"], admit_ms=run["admit_ms"],
        tokens_per_s=run["tokens_per_s"], wall_s=run["wall_s"],
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        rank_kv_cache_bytes=eng.rank_cache_bytes(),
        kv_cache_bytes=eng.cache_bytes(),
        rank_param_bytes=sum(t.numel() * t.element_size()
                             for t in _leaves(eng.params)),
        rank_heads=[eng.model.cfg.attention.num_heads,
                    eng.model.cfg.attention.num_kv_heads],
        local_lanes=eng._local_lanes)
    if eng.hot_pages:
        out.update(hot_pages=run["hot_pages"],
                   resident_promotions_seen=run["resident_promotions_seen"],
                   residents_at_end=run["residents_at_end"],
                   hot_ids=eng.last_state.layers.hot_ids[0].tolist())
    if tape is not None:
        out.update(experts=layout.experts, expert_block=layout.expert_block,
                   w2_rows=layout.w2_rows, router_cols=layout.router_cols,
                   route_totals=run["route_totals"],
                   drops=routing_drops(run, reqs, mcfg))
    lane_order = eng._lane_order
    if mesh.rank == 0:
        out["shard_kernels"] = policy_shard_kernels(name, eng, prompts)
        bad = [p["name"] for p in out["shard_kernels"] if not p["ok"]]
        assert not bad, f"{name}: at the rank's shapes {bad} disagree " \
            f"with their plain versions: {out['shard_kernels']}"
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if name == "int8":
        fault = scale_swap_fault(mesh, mcfg, mine, proj, serving, reqs)
        if mesh.rank == 0:
            out["fault"] = fault
    del mine
    gc.collect()
    torch.cuda.empty_cache()
    if mesh.rank == 0:
        out.update(policy_references(spec, mcfg, proj, serving, reqs, run,
                                     lane_order, tape, sel))
    del run, tape, stape
    gc.collect()
    torch.cuda.empty_cache()
    mesh_barrier(mesh)
    return out


def mesh_rank_main(out_dir: str) -> None:
    """One rank of the mesh phase (spawned by ``mesh_phase``): its mesh
    from the environment (gloo: the ranks share the card), both drives,
    its report as JSON in ``out_dir``."""
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    mesh = make_serving_mesh(MESH_SHAPE)
    report = dict(rank=mesh.rank, coord=mesh.coord, backend=mesh.backend,
                  device=str(mesh.device), mesh=mesh.describe())
    for dtype in ("float32", "bfloat16"):
        report[dtype] = mesh_drive(mesh, dtype)
    report["policies"] = {}
    for spec in MESH_POLICY_DRIVES:
        t0 = time.perf_counter()
        report["policies"][spec[0]] = policy_mesh_drive(mesh, spec)
        if mesh.rank == 0:
            print(f"[mesh {spec[0]}] {time.perf_counter() - t0:.1f} s",
                  flush=True)
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(report, f)


def mesh_phase(card: str) -> dict:
    """Section 7b: what NCCL says of two ranks on one card, then the 2x2
    mesh's four ranks on the card over gloo (``mesh_rank_main``), the
    kernels built once, here, before they start. Every rank's tokens must
    be the same, its launches the path's, and rank 0's comparisons hold;
    a failed rank fails the phase."""
    import gc
    import shutil
    import torch
    from repro_torch.launch.mesh import spawn_ranks
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    t0 = time.perf_counter()
    spawn_ranks(2, nccl_probe_rank, (MESH_DIR,))
    nccl = [open(os.path.join(MESH_DIR, f"nccl{r}.txt")).read()
            for r in range(2)]
    log({"mesh_nccl_two_ranks_one_card": nccl})
    log_time("mesh phase: NCCL probe")
    spawn_ranks(math.prod(MESH_SHAPE), mesh_rank_main, (MESH_DIR,))
    reports = []
    for r in range(math.prod(MESH_SHAPE)):
        with open(os.path.join(MESH_DIR, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    wall = time.perf_counter() - t0
    out = dict(card=card, note="4 ranks sharing one card", shape="2x2",
               backend=reports[0]["backend"], nccl=nccl, wall_s=wall)
    for dtype in ("float32", "bfloat16"):
        drives = [rep[dtype] for rep in reports]
        assert all(d["tokens"] == drives[0]["tokens"] for d in drives), \
            f"{dtype}: the ranks' tokens differ"
        assert all(d["launches"] == d["launches_expected"] for d in drives)
        first = drives[0]
        out[dtype] = dict(
            plan=first["plan"],
            vs_single_device=first["vs_single_device"],
            vs_single_device_plain=first["vs_single_device_plain"],
            single_device_kernel_vs_plain=first.get(
                "single_device_kernel_vs_plain"),
            shard_kernels=first["shard_kernels"],
            parted_rows=first.get("parted_rows"),
            reference=first["reference"],
            fault=first.get("fault"),
            admissions=first["admissions"],
            prefix_hits=first["prefix_hits"],
            decode_steps=first["decode_steps"],
            tokens_per_s_rank0=first["tokens_per_s"],
            kv_cache_bytes=first["kv_cache_bytes"],
            ranks=[dict(rank=rep["rank"], coord=rep["coord"],
                        launches=d["launches"],
                        decode_step_ms=d["decode_step_ms"],
                        admit_ms=d["admit_ms"],
                        peak_memory_bytes=d["peak_memory_bytes"],
                        rank_kv_cache_bytes=d["rank_kv_cache_bytes"],
                        rank_param_bytes=d["rank_param_bytes"])
                   for rep, d in zip(reports, drives)])
    out["policies"] = {}
    for spec in MESH_POLICY_DRIVES:
        name = spec[0]
        drives = [rep["policies"][name] for rep in reports]
        assert all(d["tokens"] == drives[0]["tokens"] for d in drives), \
            f"{name}: the ranks' tokens differ"
        assert all(d["launches"] == d["launches_expected"] for d in drives)
        first = drives[0]
        out["policies"][name] = dict(
            config=spec[1], layers=first["layers"],
            layers_cut_from=first["layers_cut_from"], lanes=spec[4],
            prompts=list(spec[5]), max_seq=spec[6], kv_dtype=spec[7],
            hot_resident_fraction=spec[8], page_keep_ratio=spec[9],
            plan=first["plan"], fallback_events=first["fallback_events"],
            **{k: first[k] for k in (
                "vs_single_device", "vs_single_device_plain", "parted_rows",
                "reference", "shard_kernels", "admissions", "decode_steps",
                "kv_cache_bytes", "rank_heads", "local_lanes", "setup_s")},
            **{k: first[k] for k in (
                "single_device_kernel_vs_plain",
                "vs_single_device_self_selecting", "fault", "hot_pages",
                "resident_promotions_seen", "residents_at_end", "experts",
                "expert_block", "w2_rows", "router_cols", "drops",
                "single_device_drops")
               if k in first},
            tokens_per_s_rank0=first["tokens_per_s"],
            ranks=[dict(rank=rep["rank"], coord=rep["coord"],
                        launches=d["launches"],
                        decode_step_ms=d["decode_step_ms"],
                        admit_ms=d["admit_ms"],
                        peak_memory_bytes=d["peak_memory_bytes"],
                        rank_kv_cache_bytes=d["rank_kv_cache_bytes"],
                        rank_param_bytes=d["rank_param_bytes"],
                        **({"hot_ids": d["hot_ids"]} if "hot_ids" in d
                           else {}))
                   for rep, d in zip(reports, drives)])
        if "hot_ids" in first:
            assert all(d["hot_ids"] == first["hot_ids"] for d in drives), \
                f"{name}: the ranks hold other residents"
        vs = first["vs_single_device"]
        log(f"[serve_mesh {name}] {spec[1]} {first['layers']} layers"
            + ("" if first["layers_cut_from"] is None else
               f" (depth cut from {first['layers_cut_from']})")
            + f" on 2x2: plan {first['plan']}, fallbacks "
            f"{first['fallback_events']}, launches a rank "
            f"{first['launches']}; against one device (kernels): "
            f"{vs['admissions_compared']} admissions (worst "
            f"{vs['admit_worst_err_over_limit']:.3f} of the limit), "
            f"{vs['decode_rows_compared']} decode rows (worst "
            f"{vs['decode_worst_err_over_limit']:.3f}), greedy token match "
            f"{vs['greedy_token_match']:.3f}; step ms by rank "
            f"{[round(d['decode_step_ms'], 2) for d in drives]}, admission "
            f"ms {[round(d['admit_ms'], 2) for d in drives]}, peak bytes "
            f"{[d['peak_memory_bytes'] for d in drives]} on {card}")
    data = [rep["bfloat16"]["data_only"] for rep in reports]
    assert all(d["tokens"] == data[0]["tokens"] for d in data), \
        "data-only mesh: the ranks' tokens differ"
    out["data_only_bfloat16"] = dict(
        shape=data[0]["shape"], vs_single_device=data[0]["vs_single_device"],
        admissions=data[0]["admissions"],
        decode_steps=data[0]["decode_steps"],
        admit_graph_buckets=data[0]["admit_graph_buckets"],
        tokens_per_s_rank0=data[0]["tokens_per_s"],
        ranks=[dict(rank=r, launches=d["launches"],
                    decode_step_ms=d["decode_step_ms"],
                    admit_ms=d["admit_ms"],
                    peak_memory_bytes=d["peak_memory_bytes"])
               for r, d in enumerate(data)])
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    log({"serve_mesh": out})
    log_time("mesh phase")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == TRACED_DRIVE_FLAG:
        return traced_drive_child(sys.argv[2])
    from repro_torch.kernels import _build

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    log("tf32: off for float32 matmuls and cuDNN")

    t0 = time.perf_counter()
    build_logs = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, text in build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("Function properties", "registers",
                                       "spill", "wgmma", "setmaxnreg")):
                log(f"[ptxas {name}] {line.strip()}")
    log(f"build: {build_s:.1f} s")
    log_time("build")
    # the bf16 routes of the prefill, flash and decode kernels run on
    # tensor cores; the prefill's and flash's are warp-specialized
    # (USETMAXREG) and copy by TMA tensor maps (UTMALDG); their float32
    # routes run on the tensor cores too (HGMMA: wgmma on TF32)
    sass = {}
    for name, fn_tag, design in (
            ("aqua_prefill", "aqua_prefill_bf16", ("USETMAXREG", "UTMALDG")),
            ("flash_attention", "flash_bf16", ("USETMAXREG", "UTMALDG")),
            ("aqua_prefill", "aqua_prefill_f32", ("HGMMA",)),
            ("flash_attention", "flash_f32", ("HGMMA",)),
            # head dims past 128 (RecurrentGemma's 256): the same engine's
            # wide kernels, on wgmma
            ("aqua_prefill", "aqua_prefill_bf16_wide",
             ("HGMMA", "USETMAXREG", "UTMALDG")),
            ("flash_attention", "flash_bf16_wide",
             ("HGMMA", "USETMAXREG", "UTMALDG")),
            ("aqua_decode", "decode_bf16", ())):
        if name not in sass:
            sass[name] = counts = sass_counts(str(_build._lib_path(name)))
            for fn, c in counts.items():
                log(f"[sass {name}] {fn}: " + ", ".join(
                    f"{n} {op}" for op, n in c.items()))
        counts = sass[name]
        tagged = [c for fn, c in counts.items() if fn_tag in fn]
        assert tagged and all(c["HMMA"] + c["HGMMA"] > 0 and all(
            c[op] > 0 for op in design) for c in tagged), (name, counts)
    # the decode's group route in its full-precision, int8 (kQuant),
    # participating-page (kPart) and int8 participating-page instantiations,
    # each at both widths: decode_bf16<kKS, kMT, kQuant, kPart>, mangled
    # ...ILi8ELi8ELb1ELb0E...
    counts = sass["aqua_decode"]
    variants = {}
    for fn, c in counts.items():
        m = re.search(r"decode_bf16ILi(\d+)ELi(\d+)ELb([01])ELb([01])E", fn)
        if m:
            variants[tuple(int(x) for x in m.groups())] = c["HMMA"] + c["HGMMA"]
    want = {(ks, ks, qt, pt) for ks in (8, 16)
            for qt, pt in ((0, 0), (1, 0), (0, 1), (1, 1))}
    assert set(variants) == want and all(variants.values()), variants
    log({"sass_decode_group_variants": {
        f"kKS{k[0]}_quant{k[2]}_part{k[3]}": n for k, n in variants.items()}})
    # the float32 group route, decode_f32<kG, kWide> (...ILi2ELb0E...): its
    # scores and P·V on FFMA in every instantiation, and no spills
    f32_ffma = {}
    for fn, c in counts.items():
        m = re.search(r"decode_f32ILi(\d+)ELb([01])E", fn)
        if m:
            f32_ffma[f"kG{m.group(1)}_wide{m.group(2)}"] = c["FFMA"]
    assert len(f32_ffma) == 8 and all(f32_ffma.values()), f32_ffma
    if build_logs["aqua_decode"]:
        spills = {fn: n for fn, n in ptxas_spills(
            build_logs["aqua_decode"]).items() if "decode_f32" in fn}
        assert len(spills) == 8 and not any(spills.values()), spills
    else:
        spills = "not checked: the library was built by an earlier run"
    log({"sass_decode_f32_variants": f32_ffma, "ptxas_spill_bytes": spills})
    # the wide kernels (head dims past 128: the prefill's three depths and
    # flash's two, each with and without kPart / kLen) and every float32
    # instantiation of the prefill and flash (value slices): no spills,
    # and their products kept asynchronous (no ptxas C7511)
    wide_spills, serialized = {}, []
    for name, n_wide in (("aqua_prefill", 6), ("flash_attention", 4)):
        if build_logs[name]:
            spills = ptxas_spills(build_logs[name])
            assert sum("_wide" in fn for fn in spills) == n_wide, spills
            wide_spills.update({fn: n for fn, n in spills.items()
                                if "_wide" in fn or "_f32" in fn})
            serialized += [fn for fn in ptxas_serialized(build_logs[name])
                           if "_wide" in fn or "_f32" in fn]
            serialized += [fn for fn in ptxas_any_serialized(build_logs[name])
                           if "_f32" in fn and fn not in serialized]
    assert not any(wide_spills.values()) and not serialized, \
        (wide_spills, serialized)
    # the float32 engine's instantiations (VEC 1 / 4; the narrow form at
    # 64 and 128 columns, the wide form at three key-tile and column
    # shapes, flash at two; the prefill also with kPart), each on HGMMA
    f32_tc = {name: {fn: c["HGMMA"] for fn, c in sass[name].items()
                     if fn_tag in fn}
              for name, fn_tag in (("aqua_prefill", "aqua_prefill_f32"),
                                   ("flash_attention", "flash_f32"))}
    assert [len(f32_tc["aqua_prefill"]), len(f32_tc["flash_attention"])] \
        == [20, 8] and all(n > 0 for c in f32_tc.values()
                           for n in c.values()), f32_tc
    log({"sass_f32_hgmma": f32_tc})
    log({"ptxas_spill_bytes_wide_and_f32": wide_spills or
         "not checked: the libraries were built by an earlier run",
         "ptxas_serialized_wide_and_f32": serialized})

    # the traced paged drive, in a child process: where the device time goes
    prof = traced_drive(card)

    gen = torch.Generator(device="cuda").manual_seed(0)
    phases = []

    for geom, h, kvh in (("qwen3-0.6b", 16, 8), ("llama3.1-8b", 32, 8)):
        phases.append(decode_phase(geom, h, kvh, False, gen))
        phases.append(decode_phase(geom, h, kvh, True, gen))
        # the drives' contexts: 128-1056 tokens in a 2048-token table
        phases.append(decode_phase(geom, h, kvh, True, gen, s=2048,
                                   len_range=(128, 1056), form="served"))
        if geom == "qwen3-0.6b":
            # prefix sharing's tables: every lane maps the same first 8
            # pages (the prefix_paged drive's 512-token prefix)
            phases.append(decode_phase(
                geom, h, kvh, True, gen, s=2048, len_range=(640, 1056),
                form="shared", shared_pages=SHARED_PREFIX["prefix_paged"]
                // 64))
        for quant, part in ((True, False), (False, True), (True, True)):
            phases.append(paged_variant_phase(geom, h, kvh, quant, part, gen))
        # the group route's variants at the drives' contexts
        for quant, part in ((True, False), (False, True), (True, True)):
            phases.append(paged_variant_phase(
                geom, h, kvh, quant, part, gen, s=2048,
                len_range=(128, 1056), form="served"))
        phases.append(prefill_phase(geom, h, kvh, gen))
        # the drives' longest prompt: one wave of blocks
        phases.append(prefill_phase(geom, h, kvh, gen, s=1024, form="served"))
        phases.append(prefill_chunk_phase(geom, h, kvh, gen))
        phases.append(prefill_part_phase(geom, h, kvh, gen))
        phases.append(flash_phase(geom, h, kvh, gen))
        phases.append(flash_phase(geom, h, kvh, gen, s=1024, form="served"))
        if geom == "qwen3-0.6b":
            # a bucket-padded admission's call: keys past the length
            # masked, the pad rows held too
            phases.append(flash_phase(geom, h, kvh, gen, s=1024,
                                      form="lengths", pad=21))
    # this slice's configs: Qwen1.5-4B (MHA: the bf16 group route with 7 of
    # its block's 8 heads past the group, the float32 group route at one
    # head) and Minitron-4B (group 3: 5 of 8 past it; the float32 route
    # rounds 3 up to 4 heads), paged decode in bf16 and float32 and the
    # prefill
    from repro_torch.configs import get_config
    for geom, *_ in GROUP_CONFIGS:
        att = get_config(geom).attention
        h, kvh = att.num_heads, att.num_kv_heads
        if geom == "qwen2-moe-a2.7b":
            continue                 # OLMoE's geometry (16 / 16 heads)
        phases.append(decode_phase(geom, h, kvh, True, gen))
        phases.append(decode_phase(geom, h, kvh, True, gen, s=2048,
                                   len_range=(128, 1056), form="served"))
        if geom == "olmoe-1b-7b":
            # the MoE family (MHA, 16 heads): a step's idle lanes, whose
            # values the router reads, and a padded admission's pad rows
            phases.append(decode_phase(geom, h, kvh, True, gen, s=2048,
                                       len_range=(128, 1056), form="idle",
                                       idle=3))
            phases.append(prefill_phase(geom, h, kvh, gen))
            phases.append(prefill_phase(geom, h, kvh, gen, s=1024,
                                        form="served", pad=21))
            continue
        phases.append(decode_phase(geom, h, kvh, True, gen, s=2048,
                                   len_range=(128, 1056), form="served",
                                   dtype="float32"))
        phases.append(prefill_phase(geom, h, kvh, gen))
        phases.append(prefill_phase(geom, h, kvh, gen, s=1024,
                                    form="served"))
    # the generic kernels: shapes outside the served ones' compile-time
    # depth and width (flash at head_dim 80, a prefill union of 8 chunks
    # with Dv 128)
    phases.append(flash_phase("h2o-danube-1.8b", 32, 8, gen, d=80,
                              form="generic"))
    phases.append(prefill_phase("qwen3-0.6b", 16, 8, gen, k_ratio=0.5,
                                form="generic"))
    # Whisper-tiny's decoder (MHA, 6 heads of 64 dims: 6 of 8 dim-blocks):
    # the contiguous decode at the drive's contexts, the prefill at its
    # longest prompt (off the 128-row tile) and at its 448 positions
    phases.append(decode_phase("whisper-tiny", 6, 6, False, gen, s=448,
                               len_range=(37, 261), form="served", d=64))
    phases.append(prefill_phase("whisper-tiny", 6, 6, gen, s=229,
                                form="served", d=64))
    phases.append(prefill_phase("whisper-tiny", 6, 6, gen, s=448, d=64))
    torch.cuda.reset_peak_memory_stats()
    window_phase = prefill_window_phase("h2o-danube-1.8b", 32, 8, 80, gen)
    phases.append(window_phase)
    # RecurrentGemma-9B's attention (16 heads over one KV head of 256
    # dims, window 2048): the engine's wide kernels of the prefill (window
    # and no-window forms) and of flash (AQUA off), and the float32 routes'
    # value slices at the same shapes
    wide = {dtype: (prefill_window_phase("recurrentgemma-9b", 16, 1, 256,
                                         gen, s=4096, window=2048,
                                         heads=True, dtype=dtype),
                    flash_window_phase("recurrentgemma-9b", 16, 1, 256, gen,
                                       dtype=dtype))
            for dtype in ("bfloat16", "float32")}
    for pair in wide.values():
        phases += pair
    # a lane of length 0 (ServeEngine.generate passes a caller's lengths
    # through): the narrow and generic kernels of both, in both dtypes
    empty = [empty_lane_phase(name, variant, dtype, gen)
             for name in ("aqua_prefill", "flash_attention")
             for variant in ("narrow", "generic")
             for dtype in ("bfloat16", "float32")]
    for p in phases + empty:
        log(p)
    log({"read_rate": read_rate()})
    log_time("kernel phases")
    bad = [p for p in phases + empty if not p["ok"]]
    assert not bad, f"kernel disagrees with its plain version: {bad}"

    serve = serve_phase(card, prof)
    configs = config_drive_phase(card)
    configs.update(frontend_drive_phase(card))
    recurrent = recurrent_drive_phase(card)
    hf = hf_serve_phase(card, gen)
    train = qwen3_training(card)
    log({"train": train})
    evaluation = eval_phase(card)
    log({"eval": evaluation})
    log_time("training and evaluation")
    mesh = mesh_phase(card)
    src = "src/repro_torch/kernels/csrc/"
    tpu = "src/repro/kernels/"
    sources = {
        "aqua_decode": ("aqua_decode.cu", "aqua_decode.py:50"),
        "aqua_paged_decode": ("aqua_decode.cu", "aqua_decode.py:99"),
        "aqua_paged_quant_decode": ("aqua_decode.cu", "aqua_decode.py:222"),
        "aqua_paged_part_decode": ("aqua_decode.cu", "aqua_decode.py:107"),
        "aqua_paged_part_quant_decode": ("aqua_decode.cu",
                                         "aqua_decode.py:164"),
        "aqua_prefill": ("aqua_prefill.cu", "aqua_prefill.py:58"),
        "aqua_prefill_part": ("aqua_prefill.cu", "aqua_prefill.py:129"),
        "flash_attention": ("flash_attention.cu", "flash_attention.py:22")}
    # each kernel's launches in the drive of its own path (the prefill
    # kernel's is the paged one), and in every drive
    main_path = {"aqua_decode": "contiguous", "aqua_paged_decode": "paged",
                 "aqua_paged_quant_decode": "int8_paged",
                 "aqua_paged_part_decode": "hier_paged",
                 "aqua_paged_part_quant_decode": "hier_int8_paged",
                 "aqua_prefill": "paged", "aqua_prefill_part": None,
                 "flash_attention": "flash_paged"}
    drives = [k for k, v in serve.items() if isinstance(v, dict)
              and "launches" in v]
    kernels = []
    for p in phases:
        if p["geometry"] != "qwen3-0.6b" or p.get("form") is not None:
            continue
        name = p["name"]
        by_path = {path: serve[path]["launches"][name] for path in drives}
        if main_path[name] is None:
            # the participating-chunk prefill lies on no served path, as
            # in the JAX package (only a direct call reaches _part_kernel):
            # its launches are its own phase's, and no drive may launch it
            assert not any(by_path.values()), (name, by_path)
            launches = p["phase_launches"]
        else:
            launches = by_path[main_path[name]]
        assert launches > 0, (name, by_path)
        kernels.append(dict(
            name=name, route="cuda", source=src + sources[name][0],
            replaces=tpu + sources[name][1],
            launches=launches, launches_by_path=by_path,
            max_abs_err=p["max_abs_err"], ms=p["ms"], plain_ms=p["plain_ms"],
            bound_ms=p["bound_ms"], bound_by=p["bound_by"],
            achieved_gbs=p.get("achieved_gbs"), library_ms=p["library_ms"]))
    # the window form of the prefill, at the windowed model's geometry,
    # launched by the sliding-window drive
    wp = window_phase
    next(k for k in kernels if k["name"] == "aqua_prefill")["window_form"] = \
        dict(geometry=wp["geometry"], shape=wp["shape"],
             launches=serve["swa_paged"]["launches"]["aqua_prefill"],
             max_abs_err=wp["max_abs_err"], ms=wp["ms"],
             plain_ms=wp["plain_ms"], bound_ms=wp["bound_ms"],
             bound_by=wp["bound_by"], library_ms=wp["library_ms"],
             no_window_ms=wp["no_window_ms"])
    # the wide kernels at RecurrentGemma-9B's geometry (head_dim 256),
    # launched by the hybrid's drives: the prefill with AQUA, flash
    # without; bf16 (``wide_form``) and float32 (``wide_form_float32``)
    for dtype, form, suffix in (("bfloat16", "wide_form", ""),
                                ("float32", "wide_form_float32", "_f32")):
        for k, p, path in zip(("aqua_prefill", "flash_attention"),
                              wide[dtype],
                              (f"recurrentgemma-9b{suffix}",
                               f"recurrentgemma-9b{suffix}_flash")):
            launches = recurrent[path]["launches"][k]
            assert launches > 0, (k, path)
            next(x for x in kernels if x["name"] == k)[form] = dict(
                geometry=p["geometry"], dtype=dtype, route=p["route"],
                value_slices=p["value_slices"], shape=p["shape"],
                launches=launches, max_abs_err=p["max_abs_err"],
                ms=p["ms"], plain_ms=p["plain_ms"],
                bound_ms=p["bound_ms"], bound_by=p["bound_by"],
                library_ms=p["library_ms"], no_window_ms=p["no_window_ms"],
                sdpa_causal_ms=p["sdpa_causal_ms"])
    # flash on a bucket-padded admission (keys past the length masked),
    # as the flash drive's admissions call it
    lp = next(p for p in phases if p["name"] == "flash_attention"
              and p["form"] == "lengths")
    next(k for k in kernels if k["name"] == "flash_attention")[
        "lengths_form"] = dict(
            geometry=lp["geometry"], shape=lp["shape"],
            launches=serve["flash_paged"]["launches"]["flash_attention"],
            max_abs_err=lp["max_abs_err"], ms=lp["ms"],
            plain_ms=lp["plain_ms"], bound_ms=lp["bound_ms"],
            bound_by=lp["bound_by"], library_ms=lp["library_ms"])
    # a lane of length 0 in each kernel, dtype and variant (correctness
    # forms: no times)
    for k in kernels:
        rows = [dict(variant=p["variant"], dtype=p["dtype"],
                     geometry=p["geometry"], shape=p["shape"],
                     max_abs_err=p["max_abs_err"], tol_ratio=p["tol_ratio"],
                     mean_of_v_err=p["mean_of_v_err"],
                     fault_tol_ratios=p["fault_tol_ratios"])
                for p in empty if p["name"] == k["name"]]
        if rows:
            k["empty_lane_form"] = rows
    # the float32 routes, launched by the HF checkpoint's drives
    for p in hf["phases"]:
        assert hf["f32_launches"][p["name"]] > 0, (p["name"], hf)
        next(k for k in kernels if k["name"] == p["name"])["float32_route"] = \
            dict(route=p["route"], shape=p["shape"],
                 launches=hf["f32_launches"][p["name"]],
                 max_abs_err=p["max_abs_err"], ms=p["ms"],
                 plain_ms=p["plain_ms"], bound_ms=p["bound_ms"],
                 bound_by=p["bound_by"], library_ms=p["library_ms"])
    # the kernels at this slice's GQA groups, launched by those configs'
    # drives
    for k in kernels:
        rows = [dict(geometry=p["geometry"], form=p["form"],
                     dtype=p["dtype"], shape=p["shape"],
                     launches=configs[p["geometry"]]["launches"][k["name"]],
                     max_abs_err=p["max_abs_err"], ms=p["ms"],
                     plain_ms=p["plain_ms"], bound_ms=p["bound_ms"],
                     bound_by=p["bound_by"], library_ms=p["library_ms"])
                for p in phases if p["name"] == k["name"]
                and p["geometry"] in configs]
        if rows:
            assert all(r["launches"] > 0 for r in rows), rows
            k["group_geometries"] = rows
        k["launches_by_config"] = {c: configs[c]["launches"][k["name"]]
                                   for c in configs}
    # the evaluation path's launches (ServeEngine.score): the prefill
    # kernel with AQUA on, flash with it off; the training runs none
    for k in kernels:
        k["launches_by_path"]["score"] = evaluation["score_launches"][
            k["name"]]
        k["launches_by_path"]["train"] = train["launches"][k["name"]]
        # the mesh drives' launches on rank 0 (every rank's are the same),
        # and the kernels held to their plain versions at the mesh's
        # shard-local shapes
        for dtype in ("float32", "bfloat16"):
            k["launches_by_path"][f"mesh_2x2_{dtype}_rank0"] = \
                mesh[dtype]["ranks"][0]["launches"][k["name"]]
            if k["name"] in mesh[dtype]["shard_kernels"]:
                k.setdefault("mesh_shard_form", []).append(
                    mesh[dtype]["shard_kernels"][k["name"]])
        k["launches_by_path"]["mesh_4x1_bfloat16_rank0"] = \
            mesh["data_only_bfloat16"]["ranks"][0]["launches"][k["name"]]
        # this slice's policy and family drives on 2x2, and the kernels at
        # their ranks' shapes, each with its drive's launches
        for drive, res in mesh["policies"].items():
            launched = res["ranks"][0]["launches"][k["name"]]
            k["launches_by_path"][f"mesh_2x2_{drive}_rank0"] = launched
            for p in res["shard_kernels"]:
                if p["name"] != k["name"]:
                    continue
                assert launched > 0, (drive, k["name"])
                k.setdefault("mesh_shard_form", []).append(dict(
                    drive=drive, geometry=p["geometry"], form=p["form"],
                    shape=p["shape"], launches=launched,
                    max_abs_err=p["max_abs_err"], ms=p["ms"],
                    plain_ms=p["plain_ms"], bound_ms=p["bound_ms"],
                    bound_by=p["bound_by"], library_ms=p["library_ms"],
                    fault_tol_ratios=p["fault_tol_ratios"]))
    assert sorted(k["name"] for k in kernels) == sorted(KERNELS)
    log_time("done")
    log(card)                      # name, power.limit as nvidia-smi prints
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
