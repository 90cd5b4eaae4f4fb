#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (none catches an exception; any failure exits non-zero):

1. Environment: the card's name and power limit, torch/CUDA versions, the
   compute capability (must be 9.0), and the start of the build of every
   hand kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, all in parallel); each kernel's first call in phase 2 waits for
   its own compile, so phase 2's first cells run while the slower sources
   compile, and after phase 2 every compile has finished (its seconds
   logged).
2. Kernels against their plain PyTorch versions at the main paths' real
   sizes, in two parts: (a) ``gather_distance``, the descent and
   ``beam_search``, whose sources compile first, then phase 5 (whose
   bulk build needs only those until its ``exact_query``) while
   ``flash_decode``'s and ``distance_topk``'s sources compile, then (b)
   ``flash_decode``, ``distance_topk`` and ``embedding_bag`` — MeMemo's
   1M x 384 cosine corpus (configs/mememo.py) and the llama3-8b decode
   geometry — each timed with CUDA events beside its
   plain version, its bound and, where PyTorch computes the same function,
   that call. ``gather_distance``, the greedy descent and
   ``beam_search`` run on the same rows and queries under each row codec
   (fp32; bf16; int8 + scales, encoded by the port's codec).
   ``gather_distance`` (the hop kernel) runs three cells, B 1024 x K 32,
   a served hop (B 8 x K 16) and a bulk-build hop (B 1024 x K 5), each
   cycling over enough id sets that every call finds its rows cold. The
   descent (``ops.greedy_descent``, one launch a search) runs the served
   (B 8, M 16) and the build (B 1024, M 5) shapes on random upper tables
   [L, 1M, M], held bit for bit against the per-hop loop through the hop
   kernel and against its plain version, timed beside both, with its
   hops and the bound of the lists and rows its traversal reads.
   ``beam_search`` runs exactly on integer-valued l2
   rows (int8 with scales 1.0) and in three cells: B 1024
   at T 4 and 1 (ef 64); the served tick, B 8, the calls cycling over 128
   disjoint query sets; and, for int8, the bulk build's launch (B 1024,
   the graph's first 10 columns, ef 20); each with its hop count, block
   plan (threads, rows in flight, shared bytes), blocks resident an SM
   and pair-bytes floor beside the bound. Phase 1 logs the kernel's
   registers and spills (``nvcc -Xptxas -v``). ``distance_topk`` runs on the rows of a
   1M x 384 ``FlatVectorIndex`` under each codec, at B 1, 8 (the served
   flat batch) and 128, k 10, one launch a search, on random cosine rows,
   on integer-valued l2 rows (exact), and on a row count whose last row
   range holds fewer than k rows; then k 1000 at B 8 (four passes), the
   64- and 256-slot lists (k 40, 200), the ip metric and scalar row loads
   (D 30) on the same rows; each cell's device time split into the kernel
   and everything else (no other kernel runs at k <= 256).
   ``flash_decode`` runs three cells of the llama3-8b decode geometry (H
   32, KVH 8, Dh 128): B 8 at S 8192 with ragged lengths, B 8 with every
   row at 8192, and the served cache (4 slots x 256, live 2-256) with one
   cache per layer, cycled; each held against its plain version (2e-5)
   and SDPA, with one launch a call and no other kernel in its trace.
   ``embedding_bag`` runs at MIND's published table
   (1M x 64, fp32 and bf16; configs/mind.py) with bags of L 50 at the
   recsys serve batches 512 and 262,144, ``sum`` and ``mean``, with a
   weight mask and without weights, against its plain version (rtol 1e-5,
   atol 1e-5) and, on integer-valued rows with 0/1 weights, exactly;
   beside it ``torch.nn.functional.embedding_bag`` on the fp32 table. No
   model path calls this kernel; its entry point, ``ops.embedding_bag``,
   is run once more per table dtype, counted, and held against the plain
   version.
3. The HNSW served path, through ``repro_torch.launch.serve.run`` with
   ``--rag --index hnsw``: full-width llama3-8b (all 32 layers, fp32
   random weights from a seeded ``torch.Generator``) over the built-in
   corpus plus 2,000 synthetic documents, 8 requests, 16 new tokens each,
   4 slots. The kernel launch counters are zeroed just before and read
   just after; every kernel of the path must have launched, the upper
   layers descending in one launch a search with no host sync. The retrieved
   keys must equal a CPU search of the same host graph (plain versions),
   and ``HNSW.exact_query`` on the card must equal it on the CPU.
   At the served cache geometry (slots x max_len, each slot at its own
   depth) the flash kernel must match its plain version (and is timed
   cycling through the model's 32 layer caches), and one full-width
   ``decode_step`` must agree between the flash kernel and the dense
   path. The model is released before phase 4.
4. The flat served path, ``--rag --index flat --index-dtype int8``, with
   the same model shape, corpus and requests: ``distance_topk`` must
   launch once per retrieval search and ``flash_decode`` once per layer
   per decode tick; the served keys must equal a CPU ``FlatVectorIndex``
   (int8) of the same corpus, and the kernel's over-fetched candidates
   on the served rows must equal its plain version's. fp32 and bf16 flat
   indexes on the card (each run counted) must return the CPU's keys, and
   the fp32 keys must equal phase 3's ``exact_query``.
5. The bulk builder: (a) ``bulk_build`` of 10,000 x 64 integer-valued l2
   rows (M 8, efConstruction 40, batch 1024) on the card equals the same
   call on the CPU bit for bit; (b) ``make_index("hnsw", M=5,
   ef_construction=20, use_bulk_build=True, dtype="int8")`` bulk-inserts
   MeMemo's ``build_1m`` shape (1M x 384 seeded cosine rows): wall time,
   ``hnsw.h2d_bytes``, kernel launches (one descent and one beam launch a
   batch, no host sync) and the resident device bytes
   (rows x (384 + 4) plus the graph); the descent held again on the
   built index's 1,024 queries; ``query_batch`` at ef 64, k 10 over
   1,024 queries must return the keys of a CPU search of the same host
   graph on >= 99 % of a 256-query sample; recall@10 against
   ``exact_query``, and on a 2,500-row prefix the bulk and the
   sequential builder's recall (bulk >= sequential - 0.05); (c) a
   32,768-row prefix build, timed and then traced, gives the device's
   busy and idle share of a build; (d) the durable store on (b)'s index:
   attach an ``IndexStore`` and snapshot, apply 8 inserts, 8 updates
   and 16 deletes (WAL-logged), drop the index, warm-restore it with
   ``make_index("hnsw", store=...)`` and hold it against the live one
   (the same keys on the 1,024 queries, the same ``mutation_epoch``,
   equal ``state_dict`` arrays), timing the snapshot and the restore
   (read, replay, first upload) beside (b)'s build; (e) compact with
   secure delete on a 2,500-row int8 prefix: no deleted row's bytes in
   any file of the store, and the compacted store restores with the live
   keys.
6. The HNSW served path over int8 rows, ``--rag --index hnsw
   --index-dtype int8``, with the same model shape, corpus and requests:
   the int8 instances of ``gather_distance`` and ``beam_search`` and
   ``flash_decode`` must launch; the served keys must equal a CPU copy
   of the served index (the same host graph, searched by the plain
   versions); a bf16 HNSW of the corpus built on the card (its run
   counted) must return a CPU copy's keys; and the hop kernel's route,
   an fp32, bf16 and int8 HNSW of the corpus searched with the per-hop
   layer-0 beam (``beam_impl="jnp"``, each run counted), must return the
   CPU copy's keys.
7. The same int8 HNSW served path with ``--store-dir``, cold and then
   warm: the warm run restores the index, inserts nothing (the epoch, the
   WAL and the snapshots stay as the cold run left them) and retrieves
   the cold run's keys.
8. IVF and tiered. (a) The IVF served path, ``--rag --index ivf
   --index-dtype int8``, with the same model shape, corpus and requests:
   each retrieval search launches ``gather_distance`` twice (the fp32
   instance on the centroids, K = nlist; the int8 one on the probed
   lists, K = nprobe x cap) and ``flash_decode`` launches once per layer
   per decode tick; the served keys must equal a CPU ``IVFVectorIndex``
   restored from the card index's ``state_dict`` (the same centroids);
   fp32 and bf16 IVF indexes of the corpus (each run counted) must
   return the CPU's keys; then ``--rag --index tiered``, whose search is
   host numpy through the two-tier store, must retrieve a CPU
   ``TieredIndex``'s keys, and from cold tiers both must count the same
   ``TierStats``. (b) IVF at the paper's scale: ``build_1m``'s 1M x 384
   seeded cosine rows, int8, nlist 64 and nprobe 8 (RetrievalConfig),
   attached to a store and snapshotted: k-means twice on the card, timed
   and equal bit for bit (and to the index's own training at its first
   search, which logs ``derived.centroids``); the pack's wall time and
   list cap; the hop kernel's coarse and fine launches at B 8 against
   their plain versions, with device time a launch, bound and plain
   time; ``query_batch`` at B 8 and 128, k 10; a 16-query sample equal
   to the CPU's keys; ``exact_query`` (nprobe = nlist) equal to a
   ``FlatVectorIndex`` of the same int8 rows; and 32 logged mutations,
   drop and warm restore, which must give the live keys, epoch and
   centroids.
9. The sharded index, ``n_shards`` 4. On a one-card machine the shards
   share cuda:0 through ``REPRO_TORCH_SHARD_DEVICES`` (their launches run
   one after another); with two or more cards the 1M cells run again
   with one shard a card, and otherwise the log says they did not. (a)
   ``build_1m``'s 1M x 384 seeded cosine rows in int8 flat and IVF
   indexes (nlist 64, nprobe 8) at 4 shards, made from the 1-shard
   indexes' state (IVF on their trained centroids): a 16-query sample's
   keys equal the 1-shard index's; one counted search launches
   ``distance_topk`` ceil((k + slack_s) / 256) times a shard (flat: each
   shard fetches k + its own free slots), the coarse hop once and the
   fine hop once a shard (IVF); the wall of a search at B 8 and 128
   against one shard; each shard's ``distance_topk`` call (k + slack_s
   rows) held against its plain version, every column, and its fine hop
   launch (K = nprobe x its cap) against its plain version, both timed
   with their bound, and the tree merge's time against the all-gather
   oracle; then 1,000 deletes leave free slots in each shard's block, so
   a shard's ``distance_topk`` runs in several passes: keys against one
   shard with the same deletes, each shard's call against its plain
   version. (b) HNSW over 2,500 x 384 seeded rows at
   4 shards (the paper's M 5, efConstruction 20; each child built by the
   host builder): keys equal the loop oracle's (each child searched on
   its own, a host merge), ``exact_query`` equals a 1-shard index's,
   every child's descent (bit for bit against the per-hop loop) and beam
   against their plain versions at B 8 and 128, one counted search
   launches the beam once a shard and the descent once a child with
   upper layers, the wall at B 8 and 128 against the 1-shard index, and
   one child's descent and beam launches timed. (c) An int8
   flat store of 100,000 of the rows written at 4 shards restores at 1
   and one written at 1 restores at 4, with the writer's keys, epoch and
   ``state_dict``. (d) The served path ``--rag --shards 4 --index hnsw
   --index-dtype int8`` at full width: the int8 beam launches once a
   shard a search, ``flash_decode`` once a layer a decode tick, and the
   served keys equal a CPU copy of the index's.
10. The multi-tenant ``IndexPool``. (a) 128 tenants x 1,024 seeded cosine
   rows x D 384 in one arena of 64-row slabs, every tenant resident, fp32
   and int8, filled tenant by tenant (the fill's wall logged): for 16
   sampled tenants ``query_batch`` at B 8, k 10 returns the keys of a
   dedicated ``FlatVectorIndex`` on the card over the same rows and of a
   CPU pool of those tenants, each search launches ``distance_topk`` once
   (``kernel.distance_topk.<codec>``), and each tenant's slab scan (its
   slabs gathered out of the shared block) equals the plain version on
   the same gathered rows (``assert_topk_agree``); ``query_batch_multi``
   at B 128 over 128 tenants returns the keys of the 128 single-tenant
   calls; the walls against the dedicated index and the single calls,
   ``arena_device_bytes`` and tenants a GB; and one tenant's slab scan
   timed beside its bound, plain version and ``torch.mm`` +
   ``torch.topk``. (b) 64 int8 tenants x 256 rows with 32 resident slots
   over per-tenant stores under ``build/scratch/``: evict and admit
   cycles (each timed) with logged mutations between them leave every
   tenant's state arrays, epoch and keys bit for bit those of a pool
   that never evicts. (c) ``compact`` on one of those tenants after 32
   deletes: the deleted rows' fp32, normalized and int8 bytes are in no
   host array of the arena, no packed block read back from the card and
   no store file; the other tenants' epochs stay. (d) ``--rag --tenants
   4 --max-resident 2 --index-dtype int8 --store-dir`` at full width,
   cold then warm: the warm run inserts nothing, and the keys equal a CPU
   pool's restored from the served pool's stores. (e) (a)'s int8 pool at
   4 shards on cuda:0 repeated: the sampled keys equal one shard's, and
   each shard's slab scan equals its plain version.

11. The other LMs of ``launch.serve --arch``, each at its published
   config (every layer, full widths, fp32 random weights from a seeded
   ``torch.Generator``), one resident at a time: h2o-danube-3-4b
   (sliding window 4,096, Dh 120, G 4), minitron-8b (the llama geometry,
   a 256,000-token vocab), olmoe-1b-7b (64 experts top 8, G 1) and
   granite-moe-3b-a800m (40 experts top 8, Dh 64, G 3). (a) Phase 4's
   served path, ``--rag --index flat --index-dtype int8``: ``flash_decode``
   once a layer a decode tick, ``distance_topk`` (int8) once a search,
   the keys phase 4 served; req/s, tok/s, peak memory and one decode
   tick's wall and device ms. (b) ``flash_decode`` at the model's served
   cache (4 slots x 256, live 2-256, one cache a layer, cycled) against
   its plain version (2e-5) on every layer, timed beside its bound and
   SDPA. (c) One full-width ``decode_step``, flash against dense. (d)
   MoE models: layer 0's MoE on 256 tokens on the card and on the CPU
   with the same weights: router ids and the keep mask equal wherever
   the k-th probability clears the (k+1)-th by 1e-5 (at least 99 % of
   tokens), outputs within 1e-4 there, two card runs equal bit for bit.
   (e) danube: B 2, a 4,608-token prompt (the prefill rolls the ring),
   64 teacher-forced decode ticks that wrap it, flash and dense agreeing
   at every tick (rtol, atol 1e-3), the last tick against a prefill of
   all 4,672 tokens (rtol, atol 1e-3; argmax equal). (f) danube under
   ``kv_quant`` (the reference's ``decode_32k`` preset): the served run
   as (a); one layer's int8 payload and scales equal the CPU's
   quantization of the same fp32 K/V, exactly; 16 teacher-forced decode
   ticks on the int8 cache, flash against dense (rtol, atol 1e-3), with
   their gap to the fp32 cache's decode logged beside the reference's
   smoke-test bound (0.02 max|logit| + 0.01), which the reference's own
   int8 scheme leaves at this width.
12. bf16 on the card. (a) ``flash_decode``'s bf16 instance at phase 2's
   llama3-8b cells (B 8 at S 8,192 ragged and full, the served 4 x 256
   cache cycled over 32 layer caches, the wide kernel at Dh 2,048) and at
   each other LM's served cache geometry (danube G 4 Dh 120, minitron G 4
   Dh 128, olmoe G 1 Dh 128, granite G 3 Dh 64), on bf16 tensors against
   its plain version (2e-5), timed beside SDPA in bf16 and the bound of
   bf16 K/V. (b) llama3-8b at full width and depth with bf16 weights
   (``init_lm(dtype=torch.bfloat16)``) serving phase 4's ``--rag --index
   flat --index-dtype int8`` through ``ServeEngine(dtype=torch.bfloat16)``
   (the engine built here: ``launch.serve`` serves fp32): the keys phase
   4 served; ``flash_decode`` on its bf16 instance once a layer a decode
   tick and no other attention; req/s, tok/s, peak memory, a tick's wall
   and device ms. (c) One full-width bf16 ``decode_step``, flash against
   dense from one cache: layer 0's attention output (fp32, before its bf16
   cast) kernel against plain within 2e-5; the two paths' logits closer
   to each other than to (d)'s fp32 decode (a bf16 rounding of their
   attention outputs is carried 32 layers on), their argmax by row, the
   top-2 margins and the gaps logged. (d) The cost of bf16: the same
   weights widened to an fp32 model, prefill and decode logits on (c)'s
   input against the bf16 model's, logged, not asserted.
   (e) The reference's ``decode_32k`` shape: h2o-danube-3-4b at full
   width, depth cut to 4 layers, bf16 weights and the int8 cache: 16
   ticks flash against dense from one int8 cache, closer to each other at
   every tick than to the same weights widened to fp32, the dequantized
   K/V handed to ``flash_decode`` in bf16 (its bf16 instance launched). (f)
   olmoe-1b-7b's layer 0 MoE in bf16 on 256 tokens, card against CPU:
   routing equal where the top-k clears a tie by 1e-5.

13. The off-path models at their published configs (random weights from a
   seeded CUDA ``torch.Generator``, TF32 off), one resident at a time;
   every check runs the same weights and inputs on the CPU as well and
   holds the card within 1e-4 x max|value| of it. (a) The recsys serve
   steps of the reference's ``launch/steps.py``: ``fm_forward`` (39 x 1M
   x 10 table) and ``wide_deep_forward`` (40 x 1M x 32, MLP 1024-512-256)
   on ``ctr_batches`` at serve_p99 (B 512; card against CPU) and at
   serve_bulk (B 262,144; timed, finite); ``bert4rec_user_embedding`` on
   ``masked_item_batches`` (B 512, S 200) and ``mind_user_embedding`` on
   ``seq_rec_batches`` (B 512, S 50), card against CPU; each step's wall
   ms, device ms (queued) and peak GB. (b) retrieval_cand: one MIND
   user's 4 interests against its 1M x 64 item table through
   ``FlatIndex.build(items, metric="ip").query(k=100)``: exactly one
   ``distance_topk`` launch (counted), (d, id) against its plain version
   on the same rows (``assert_topk_agree``), timed beside ``torch.mm`` +
   ``torch.topk`` and its bound. (c) graphsage-reddit: minibatch_lg's
   graph, ``make_graph(232,965, 492, 602, 41)`` (114,618,780 edges, 2,888
   past the published count: the generator takes an integer degree),
   built on the host in a process started before phase 10 (its seconds
   logged, and how long phase 13 waited for it); the CSR and features on
   the card, ``sample_neighbors`` at fanouts 15 and 10 for 1,024 seeds,
   the feature gather and ``sage_sampled_forward``: every sampled id a
   CSR neighbour of its seed (or the seed at zero degree), the logits
   near the CPU's on the same ids, the sampled loss finite, the sampler
   and the step timed; full_graph_sm (2,708 nodes, the first 10,556 edges
   of ``make_graph`` at degree 4, d_feat 1,433) through
   ``sage_full_forward`` twice on the card, equal bit for bit, and near
   the CPU; molecule (128 graphs x 30 nodes) through
   ``sage_molecule_forward``, card against CPU.
14. Training on the card (TF32 off, one model resident at a time): (a)
   llama3-8b at its published width (d_model 4,096, 32/8 heads, d_ff
   14,336, vocab 128,256), depth cut to 2 layers, fp32 weights from a
   seeded CUDA generator, ``launch.train``'s optimizer
   (``warmup_cosine(3e-4, 5, steps)``) and batch (``lm_batches``, B 8 x
   S 128): the B 1 loss and global grad norm against a CPU copy of the
   weights (1e-4 relative), then five ``make_train_step`` steps, each
   with its loss, wall ms, peak GB, tokens/s and TFLOP/s against the
   fp32 bound of its products, the kernel counters zeroed before it and
   no hand kernel launched in it, and the device ms a step (queued);
   (b) olmoe-1b-7b at its published width (64 experts, top 8, expert
   d_ff 1,024, vocab 50,304), 2 layers, the same readouts, the router
   ids of the first step against a CPU forward of the same batch where
   the top 8 clear a tie by 1e-5; (c) one ``lm_loss(dtype=torch.bfloat16)``
   at B 1 of (a)'s weights, card against CPU (loss within
   ``BF16_LOSS_RTOL``, grad norm within ``BF16_GNORM_RTOL``); (d) in (a)
   and (b) the first step run twice from the same state, the loss, grad
   norm, weights, m and v compared bit for bit (the leaves that differ
   logged; they must stay within 1e-5), and the same for fm at its
   published table at B 512 (``ctr_batches``' zipf ids repeat, so the
   table's gradient adds many rows into one) and for graphsage-reddit's
   full-batch smoke run (``REPEAT_RUNS``); (e) ``launch.train.main`` on
   the card: llama3-8b ``--preset small --steps 30`` (its last loss below
   its first), fm, wide-deep, bert4rec, mind and graphsage-reddit
   ``--preset smoke --steps 5`` and fm and wide-deep ``--preset small
   --steps 3`` (their published tables), each one's step ms, peak GB and
   finite losses.
15. Checkpoints, fault tolerance and the distributed training layer: (a)
   phase 14 (a)'s llama3-8b state (published width, 2 layers, one step
   taken) saved once through ``CheckpointManager(keep=1,
   async_save=True)`` into ``build/scratch/`` (the caller's stall, then
   the write's seconds, GB/s and the file's bytes, the write overlapping
   (b) to (f)), restored onto the card (seconds, GB/s, peak GB), every
   leaf bit for bit the live state's, and one step from the restored
   state bit for bit the live state's step (loss, grad norm, weights, m,
   v); (b) ``examples/torch_fault_tolerant_training.py``'s supervised
   run (``resilient_run``) on ``launch.train``'s small llama3-8b: 24 steps, a checkpoint every 8
   (async), failures at 9 and 17 (two restarts) with a
   ``StragglerWatchdog``, against a failure-free run and a failure at
   step 3 (restart from scratch), every loss and the final state bit for
   bit; each save's stall and the stragglers logged; (c)
   ``launch.train.main --preset small --steps 20 --ckpt-every 10
   --ckpt-dir D``, then ``--steps 30`` resumes at step 20 (its first
   loss logged); (d) ``pipeline_apply``: four stages of one llama3-8b
   layer each at its published width (``transformer.layer_stage``), 8
   microbatches of 1 x 128 tokens on a 4-stage mesh (``cuda:0`` repeated
   on one card), the output and the gradients of its sum against the
   sequential oracle, bit for bit where the stages share a card (1e-5
   otherwise), the ticks (11), the bubble fraction and the ms; (e)
   ``compressed_psum`` over 4 replicas of a seeded [128,256 x 4,096]
   fp32 tensor (the llama3-8b embedding gradient's shape): within the
   reference's 3 % of the exact sum, every replica equal, the int8 bytes
   moved against an fp32 ring all-reduce's and the ms; (f) (b)'s final
   state placed on a (4, 2) mesh, saved, and ``restore_sharded`` onto
   (2, 4): every block of ``spec_for``'s shape, the blocks joined equal
   to the saved leaves.
16. The dry-run tooling (``launch/{mesh,model_costs,op_analysis,steps,
   dryrun}.py``): (a) ``launch.dryrun``'s CLI counts MeMemo's
   ``query_1m`` and ``query_rt``, llama3-8b's ``decode_32k`` and fm's
   ``serve_bulk`` at their published configs on ``meta`` (pod mesh), each
   row logged; (b) the same cells on the card at their published widths
   (llama3-8b cut to 2 layers: B 128 and a bf16 cache of S 32,768 with
   every slot attending all of it), each counted once under
   ``op_analysis`` (FLOPs and bytes equal to the same cell's count on
   ``meta``, no hand kernel uncosted, flash_decode's bf16 instance once
   a layer and distance_topk once a search launched) and timed with CUDA
   events beside its bound (counted operations over the card's peaks or
   counted bytes over its HBM rate, the larger); a time under 0.95 x its
   bound fails (a count too high).
17. The examples and the legacy builder: (a) ``bulk_build_legacy`` on
   phase 5 (a)'s integer-valued l2 rows (``BULK_INT``) on the card, every
   array bit for bit the CPU's (each built in a process started before
   phase 14, so that their host loops overlap phases 14 to 16), one
   descent and one ``beam_search`` launch a batch;
   (b) ``bulk_build_legacy`` and the resident ``bulk_build`` at MeMemo's
   build widths (configs/mememo.py: D 384, M 5, efC 20, cosine; fp32,
   bootstrap 256, batch 1,024) on the same ``LEGACY_ROWS`` rows
   (``make_corpus`` rows and Gaussian queries, as ``bench_build`` draws
   them), run alone: each build's wall, rows/s, ``hnsw.h2d_bytes`` and
   their ratio (``bench_build``'s ``h2d_vs_legacy``, under 0.5), launches,
   and recall@10 at ef 64 against the exact top 10; (c) the four examples'
   ``main(device="cuda")`` with their asserts: quickstart (HNSW CRUD,
   export and load, every backend, the two-tier traffic), the RAG
   Playground at every ``--index``, each in a process of its own beside
   (a) and the other examples (host-bound: its engine prefills 127
   positions in attention blocks of 1; ``flash_decode`` every tick; the 12
   documents' keys through hnsw and tiered equal the flat scan's),
   distributed retrieval (8 shards on the mesh's devices, each one
   ``distance_topk`` launch, 0 bytes between cards on one card) and
   fault-tolerant training (2 restarts, exact replay); each run's
   launches go into the kernels line.

Each phase's seconds are logged. The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the
repository around it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import gc
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W limit): HBM rate,
# the fp32 rate outside the tensor cores, and the dense TF32 tensor-core
# rate (distance_topk at B > 8)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12

N_VECTORS, DIM = 1_000_000, 384          # configs/mememo.py
N_QUERIES, M2, EF = 1024, 32, 64
L2_BYTES = 50_000_000                    # the H100's L2
# gather_distance cells: name -> (B, K): B 1024 x K 32, a served
# descent hop (8 coalesced requests, M 16) and a bulk-build hop (M 5,
# configs/mememo.py build_1m); the descent cells: name -> (B, M)
GATHER_CELLS = {"b1024_k32": (1024, 32), "served_b8_k16": (8, 16),
                "build_b1024_k5": (1024, 5)}
DESCENT_CELLS = {"served": (8, 16), "build": (1024, 5)}
# beam_search's served tick (8 coalesced requests, M 16: 2M 32, ef 64)
# and the bulk build's launch (configs/mememo.py build_1m: M 5, efC 20)
SERVED_B, BUILD_M2, BUILD_EF = 8, 10, 20
# HNSW past M 128 (the descent in rounds of 128 list slots, the beam's
# hops in waves of 1,024 candidates): M 200 at the served B 8, on a
# random upper table [2, 1M, 200] and layer-0 graph [1M, 400] (1.6 GB
# each)
WIDE_M, WIDE_CODECS = 200, ("fp32", "int8")
# distance_topk: k from configs/base.py retrieval_cand; B 8 is the served
# flat batch, and k 1000 there takes four passes
TOPK_K, TOPK_BATCHES = 10, (1, 8, 128)
TOPK_BIG_K, TOPK_BIG_B = 1000, 8
CODECS = ("fp32", "bf16", "int8")
DEC_H, DEC_KVH, DEC_DH = 32, 8, 128       # llama3-8b decode geometry
# flash_decode cells: name -> (B, S, cur_len, caches cycled, Dh); "served"
# is the served cache (4 slots x max_len 256), one cache per layer; "wide"
# the wide-head kernel (Dh past 1,024) at the llama3-8b head counts
FLASH_CELLS = {
    "ragged": (8, 8192, [1, 33, 1000, 4097, 5000, 6143, 8191, 8192], 1,
               DEC_DH),
    "full": (8, 8192, [8192] * 8, 1, DEC_DH),
    "served": (4, 256, [2, 86, 171, 256], 32, DEC_DH),
    "wide": (8, 1024, [1024] * 8, 1, 2048),
}
SYNTHETIC_DOCS = 2000
# bulk build: (a) integer-valued l2 rows, card == CPU bit for bit; (b)
# configs/mememo.py build_1m in int8; its query sample held against the
# CPU; (c) a prefix build traced for the device's busy share
BULK_INT = dict(rows=10_000, dim=64, M=8, ef_construction=40,
                batch_size=1024)
BULK_ROWS, BULK_QUERIES, BULK_SAMPLE = 1_000_000, 1024, 256
PROFILE_ROWS = 32_768
QUALITY_ROWS = 2_500
# embedding_bag at MIND's published table (src/repro/configs/mind.py:
# n_items, embed_dim, seq_len) and the recsys serve shapes of
# configs/base.py RECSYS_SHAPES (serve_p99, serve_bulk). No model path of
# either package calls the kernel; its entry point is ops.embedding_bag,
# whose counted run is one call at serve_p99 per table dtype.
BAG_ROWS, BAG_DIM, BAG_LEN = 1_000_000, 64, 50
BAG_BATCHES = (512, 262_144)
BAG_ENTRY = "ops.embedding_bag (MIND serve_p99)"
# store phase: logged mutations on the restored 1M int8 index (kept few:
# each insert or update copies the 1M encoded rows, live and again in
# the replay), and the compact + secure-delete prefix
STORE_INSERTS, STORE_UPDATES, STORE_DELETES = 8, 8, 16
COMPACT_ROWS, COMPACT_DELETES = 2_500, 200
# IVF at the paper's scale (configs/mememo.py build_1m, int8; nlist and
# nprobe from RetrievalConfig): the query batches timed, the sample held
# against the CPU, and the store's logged mutations (inserts in one
# bulk_insert, updates, deletes)
IVF_BATCHES, IVF_SAMPLE, IVF_HOP_B = (8, 128), 16, 8
IVF_INSERTS, IVF_UPDATES, IVF_DELETES = 16, 8, 8
# phase 9: the sharded index at 4 shards (on cuda:0 repeated when the
# machine has one card); HNSW rows sized so that the four host builds (M
# 5, efConstruction 20, configs/mememo.py) take well under a minute; the
# store round trips on a prefix of the 1M int8 rows
SHARDS, SHARD_BATCHES, SHARD_SAMPLE = 4, (8, 128), 16
SHARD_HNSW_ROWS, SHARD_STORE_ROWS = 2_500, 100_000
# phase 9 deletes every this many-th key of the 1M flat indexes: about
# 250 free slots a shard, so the fan-out over-fetches in several passes
SHARD_CHURN_EVERY = 1000
# phase 10: the multi-tenant pool. (a) 128 tenants x 1,024 rows x D 384
# (configs/mememo.py's dim) in one arena of 64-row slabs, every tenant
# resident, 16 of them sampled, B 8 a search and B 128 across 128
# tenants; (b) 64 tenants x 256 rows paged through 32 resident slots
POOL_TENANTS, POOL_ROWS, POOL_SLAB = 128, 1024, 64
POOL_SAMPLE, POOL_B, POOL_MULTI_B = 16, 8, 128
PAGE_TENANTS, PAGE_ROWS, PAGE_RESIDENT = 64, 256, 32
# phase 11: the other LMs of launch.serve --arch at their published
# configs; (d) an MoE layer on 256 tokens; (e) danube's ring: B 2, a
# prompt past the 4,096 window, then ticks that wrap it; (f) the int8
# cache against the fp32 one
OTHER_LMS = ("h2o-danube-3-4b", "minitron-8b", "olmoe-1b-7b",
             "granite-moe-3b-a800m")
MOE_TOKENS = 256
RING_B, RING_PROMPT, RING_STEPS = 2, 4608, 64
KVQ_PROMPT, KVQ_STEPS = 64, 16
# phase 12: bf16. (e) danube's depth cut to 4 layers under kv_quant
BF16_KVQ_LAYERS = 4
BF16_LLAMA = "llama3-8b bf16 flat int8"
# phase 13: the off-path models (configs/{fm,wide_deep,bert4rec,mind,
# graphsage_reddit}.py) at the reference's serve and graph shapes
# (configs/base.py RECSYS_SHAPES, GNN_SHAPES), each recsys model's serve
# step as launch/steps.py serves it, and retrieval_cand's k (steps.py)
RECSYS_ARCHS = ("fm", "wide-deep", "bert4rec", "mind")
SERVE_STEP = {"fm": "fm_forward", "wide_deep": "wide_deep_forward",
              "bert4rec": "bert4rec_user_embedding",
              "mind": "mind_user_embedding"}
RETRIEVAL_K = 100
RETRIEVAL_PATH = "mind retrieval_cand"
# minibatch_lg: make_graph takes an integer degree; 232,965 x 492 =
# 114,618,780 edges against the published 114,615,892
SAGE_DEGREE = 492
# phase 14: training. llama3-8b and olmoe-1b-7b at their published
# widths (configs/{llama3_8b,olmoe_1b_7b}.py), depth cut to 2 layers,
# launch.train's default batch (lm_batches, B 8 x S 128) and optimizer
TRAIN_LMS = ("llama3-8b", "olmoe-1b-7b")
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 8, 128, 5
TRAIN_PATH = "llama3-8b train step"
# (e) launch.train.main's runs: (arch, preset, steps)
TRAIN_RUNS = (("llama3-8b", "small", 30),
              *((a, "smoke", 5) for a in ("fm", "wide-deep", "bert4rec",
                                          "mind", "graphsage-reddit")),
              ("fm", "small", 3), ("wide-deep", "small", 3))
# (d) the first step twice from one state where the backward gathers
# with repeated ids: fm at its published table at serve_p99's batch
# (zipf ids: many repeats), and graphsage-reddit's full-batch smoke run
REPEAT_RUNS = (("fm", "small", 512), ("graphsage-reddit", "smoke", 8))
# (c) bf16 compute against the CPU: relative gaps of the loss and of the
# global grad norm (bf16 roundings of activations land on either side
# on the two devices and are carried through 2 layers)
BF16_LOSS_RTOL, BF16_GNORM_RTOL = 1e-2, 5e-2
# phase 15: checkpoints, fault tolerance and the distributed training
# layer. (b) a failure at step 3 beside the run of
# examples/torch_fault_tolerant_training.py; (c) launch.train's
# --ckpt-dir run and its rerun (--steps); (d) the pipeline's stages,
# microbatches and their shape; (e) compressed_psum's replicas; (f) the
# meshes a state is saved from and restored onto
FT_SCRATCH_FAIL = 3
CKPT_STEPS, CKPT_EVERY = (20, 30), 10
PIPE_STAGES, PIPE_MICRO, PIPE_MB, PIPE_S = 4, 8, 1, 128
PSUM_REPLICAS, PSUM_BOUND = 4, 0.03
MESH_SAVE, MESH_RESTORE = (4, 2), (2, 4)
# phase 16: the dry-run tooling. (a) launch.dryrun's cells on the pod mesh
# at their published configs on meta; (b) the same cells on the card at
# their published widths (llama3-8b cut to DRY_LAYERS layers), each counted
# once, on the card and on meta, and timed (reps after a warm-up)
DRY_CELLS = (("mememo", "query_1m", None, 5), ("mememo", "query_rt", None, 20),
             ("llama3-8b", "decode_32k", 2, 8), ("fm", "serve_bulk", None, 10))
DRY_MIN_SHARE_OF_BOUND = 0.95
# phase 17: the examples and the legacy builder. (a) bulk_build_legacy on
# BULK_INT's integer l2 rows, on the card and on the CPU, each built in a
# process of its own; (b) bulk_build_legacy and bulk_build at MeMemo's build
# widths (configs/mememo.py: D 384, M 5, efC 20, cosine; fp32, bootstrap
# 256, batch 1,024) on LEGACY_ROWS make_corpus rows (bench_build's draw;
# 30,000 keep phase 17 near 90 s), recall@10 of LEGACY_QUERIES Gaussian
# queries; (c) the examples, the playground at every index
LEGACY_ROWS, LEGACY_QUERIES = 30_000, 200
PLAYGROUND_INDEXES = ("flat", "ivf", "hnsw", "tiered")
# the kernels each served path must launch
HNSW_PATH = ("kernel.gather_distance", "kernel.beam_search",
             "kernel.flash_decode")
FLAT_PATH = ("kernel.distance_topk", "kernel.flash_decode")
# an IVF search: one coarse launch on the fp32 centroids, one fine launch
# on the codec's rows
IVF_INT8_PATH = ("kernel.gather_distance.fp32", "kernel.gather_distance.int8",
                 "kernel.flash_decode")
HNSW_INT8_PATH = ("kernel.gather_distance.int8", "kernel.beam_search.int8",
                  "kernel.flash_decode")
# kernel record -> the run of the main path whose launches it reports.
# The served HNSW search descends in one gather_distance launch (the
# greedy_descent records); the hop kernel's served path is IVF (its fp32
# instance scores the centroids, the codec's the probed lists), and it
# also runs on HNSW's per-hop beam; its launches are the codec's gather
# launches less the descents (HOP_COUNTER).
MAIN_PATH = {
    "greedy_descent.fp32": "hnsw fp32", "beam_search.fp32": "hnsw fp32",
    "flash_decode": "hnsw fp32",
    "greedy_descent.bf16": "hnsw bf16", "beam_search.bf16": "hnsw bf16",
    "greedy_descent.int8": "hnsw int8", "beam_search.int8": "hnsw int8",
    "gather_distance.fp32": "ivf int8", "gather_distance.bf16": "ivf bf16",
    "gather_distance.int8": "ivf int8",
    "distance_topk.fp32": "flat fp32", "distance_topk.bf16": "flat bf16",
    "distance_topk.int8": "flat int8",
    "distance_topk.retrieval_cand": RETRIEVAL_PATH,
    "embedding_bag.fp32": BAG_ENTRY, "embedding_bag.bf16": BAG_ENTRY,
    **{f"flash_decode.{a}": f"{a} flat int8" for a in OTHER_LMS},
    "flash_decode.bf16": BF16_LLAMA,
}
HOP_COUNTER = "kernel.gather_distance.hop"
# record -> the counter its launches are read from (default kernel.<name>)
COUNTER_OF = {**{f"greedy_descent.{c}": f"hnsw.descent_launches.{c}"
                 for c in ("fp32", "bf16", "int8")},
              **{f"gather_distance.{c}": f"{HOP_COUNTER}.{c}"
                 for c in ("fp32", "bf16", "int8")},
              **{f"flash_decode.{a}": "kernel.flash_decode"
                 for a in OTHER_LMS},
              "flash_decode.bf16": "kernel.flash_decode.bf16",
              "distance_topk.retrieval_cand": "kernel.distance_topk.fp32"}
# the descent is an entry point of gather_distance.cu
SOURCE_OF = {"greedy_descent": "gather_distance"}
REPLACES = {
    "gather_distance": "src/repro/kernels/gather_distance.py:170",
    "greedy_descent": "src/repro/kernels/gather_distance.py:170",
    "beam_search": "src/repro/kernels/beam_search.py:269",
    "flash_decode": "src/repro/kernels/flash_decode.py:94",
    "distance_topk": "src/repro/kernels/distance_topk.py:146",
    "embedding_bag": "src/repro/kernels/embedding_bag.py:101",
}


def hop_launches(counts: dict, codec: str) -> int:
    """The hop kernel's launches in a run: ``codec``'s gather_distance
    launches less its one-launch descents (both count as the kernel's)."""
    return (counts.get(f"kernel.gather_distance.{codec}", 0)
            - counts.get(f"hnsw.descent_launches.{codec}", 0))


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float,
          rate: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes over the HBM rate or
    operations over ``rate`` (default the fp32 rate), whichever is
    larger."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(torch, fn, reps: int) -> float:
    """Device ms a call of ``fn``, its launches queued behind a spin kernel
    so that they run back to back: the host's time between launches is
    hidden, where ``time_ms`` of a short launch reads the wrapper's host
    time. A fallback beside the profiler's time a launch, which can trace
    none."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)            # ~50 ms: covers the enqueue
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def synthetic_corpus(n: int, seed: int) -> list[tuple[str, str]]:
    """``n`` distinct documents of 12-30 words drawn from a seeded RNG over
    the built-in corpus's vocabulary plus filler words."""
    import numpy as np
    from repro_torch.data.corpus import BUILTIN_CORPUS, tokenize

    vocab = sorted({w for _, t in BUILTIN_CORPUS for w in tokenize(t)}
                   | {f"topic{i}" for i in range(200)})
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        words = rng.choice(vocab, size=int(rng.integers(12, 31)))
        docs.append((f"syn-{i}", f"note {i} " + " ".join(words)))
    return docs


# ---------------------------------------------------------------------------
def phase_environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    cap = torch.cuda.get_device_capability(0)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"capability {cap}, {torch.cuda.device_count()} device(s)")
    if cap != (9, 0):
        raise SystemExit(f"needs compute capability 9.0 (Hopper), got {cap}")
    # full-fp32 references: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    build.start()
    log(f"kernel build: one nvcc a source started for {sorted(build.SOURCES)}"
        "; each kernel's first call waits for its own")
    return smi


def build_report() -> dict:
    """Wait for every kernel's compile still running (all must have
    built) -> seconds from the start of the build to each source's wait,
    logged with the registers and spills of the kernels ``nvcc -Xptxas
    -v`` reported."""
    from repro_torch.kernels import build

    build.build()
    took = {k: round(v, 2) for k, v in build.TOOK.items()}
    log("kernel build, seconds to each source's wait " + json.dumps(took))
    for name in ("gather_distance", "beam_search", "embedding_bag",
                 "flash_decode"):
        for line in ptxas_report(name):
            log(f"{name} ptxas {line}")
    return took


def encode_rows(torch, x, codec: str, integer: bool = False):
    """fp32 rows on the card -> (rows, scales or None) of ``codec``, encoded
    by the port's codec on the host. ``integer``: integer-valued rows,
    which bf16 holds exactly and int8 holds as themselves with scales 1.0,
    so that every distance stays exact."""
    import numpy as np
    from repro_torch.core.codec import device_rows, get_codec

    if codec == "fp32":
        return x, None
    if integer and codec == "int8":
        return x.to(torch.int8), torch.ones(x.shape[0], device=x.device)
    enc, scales = get_codec(codec).encode(x.cpu().numpy())
    return (device_rows(enc, x.device),
            None if scales is None else torch.from_numpy(
                np.ascontiguousarray(scales)).to(x.device))


def row_bytes(rows, scales) -> int:
    """Bytes one row of ``rows`` occupies, its scale included."""
    return rows.shape[1] * rows.element_size() + (0 if scales is None else 4)


def check_gather(torch, codec, rows, scales, q, gen) -> dict:
    """``gather_distance`` on ``rows`` (1M x 384 of ``codec``) against its
    plain version, within 1e-5, in three cells (``GATHER_CELLS``): B 1024
    x K 32, a served hop (B 8 x K 16) and a bulk-build hop (B 1024 x
    K 5). Each is timed cycling over enough random id sets that every
    call finds its rows cold (the sets' rows pass twice the 50 MB L2).
    The record is the first cell's, with every cell beside it."""
    from repro_torch.kernels import ops, ref

    dev = q.device
    cells = {}
    for name, (b, k) in GATHER_CELLS.items():
        n_sets = max(8, -(-2 * L2_BYTES // (b * k * row_bytes(rows,
                                                               scales))))
        ids = torch.randint(0, N_VECTORS, (n_sets * b, k), device=dev,
                            generator=gen, dtype=torch.int32)
        sets = [(q[i * b % N_QUERIES:i * b % N_QUERIES + b],
                 ids[i * b:(i + 1) * b]) for i in range(n_sets)]
        err = 0.0
        for qs, ii in sets[:4]:
            got = ops.gather_distance(rows, qs, ii, scales=scales)
            want = ref.gather_distance_ref(rows, qs, ii, scales=scales)
            torch.cuda.synchronize()
            err = max(err, (got - want).abs().max().item())
        assert err <= 1e-5, f"gather_distance {codec} {name}: err {err}"
        # bytes: each distinct row (+ scale) once, q, ids, out; operations:
        # a multiply-add per element, plus the decode multiply under int8
        qs, ii = sets[0]
        per_elem = 2.0 if scales is None else 3.0
        b_ms, b_by = bound(torch.unique(ii).numel() * row_bytes(rows, scales)
                           + qs.numel() * 4 + ii.numel() * 8,
                           per_elem * ii.numel() * q.shape[1])
        cyc = itertools.cycle(sets)

        def run(fn):
            def call():
                qq, jj = next(cyc)
                return fn(rows, qq, jj, scales=scales)
            return call

        # a call at the small cells is the wrapper's host time; the
        # profiler's time a launch is the kernel's
        split = device_split(torch, run(ops.gather_distance),
                             "gather_distance_kernel", reps=32)
        assert split["other_device_ms"] == 0, f"gather_distance: {split}"
        cells[name] = dict(
            max_abs_err=err, B=b, K=k, id_sets=n_sets, **split,
            ms=time_ms(torch, run(ops.gather_distance),
                       max(48, min(n_sets, 512))),
            plain_ms=time_ms(torch, run(ref.gather_distance_ref),
                             24 if b > SERVED_B else 96),
            bound_ms=b_ms, bound_by=b_by,
            plan=ops._gather_plan(b, k, torch.cuda.get_device_properties(
                0).multi_processor_count),
            shapes=f"vectors {rows.shape[0]}x{rows.shape[1]} {codec}"
                   + ("" if scales is None else " + scales")
                   + f", q {b}x{q.shape[1]}, ids {b}x{k}")
        log(f"gather_distance {codec} {name} " + json.dumps(cells[name]))
        del ids, sets
    first = next(iter(cells))
    return dict(cells[first], library_ms=None, library="none", cells=cells)


def random_upper(torch, gen, m: int):
    """A random upper table [L, 1M, M] with 10 % -1 padding, L =
    floor(ln N / ln M): the top level a graph of 1M rows at that M
    reaches."""
    layers = int(math.log(N_VECTORS) / math.log(m))
    up = torch.randint(0, N_VECTORS, (layers, N_VECTORS, m),
                       device=gen.device, generator=gen, dtype=torch.int32)
    pad = torch.rand(layers, N_VECTORS, m, device=gen.device, generator=gen)
    return torch.where(pad < 0.1, -1, up).contiguous()


def descent_agree(torch, rows, scales, up, q, ep, ep_d, what: str) -> dict:
    """``ops.greedy_descent`` (one launch) on these queries against the
    per-hop loop through the hop kernel (bit for bit: ep and ep_dist) and
    against the plain version (ep equal on >= 99 % of queries, ep_dist
    within 1e-5 where it is)."""
    from repro_torch.kernels import ops, ref

    layers = up.shape[0]
    kw = dict(max_level=layers, scales=scales)
    ge, gd = ops.greedy_descent(rows, up, q, ep, ep_d, **kw)
    le, ld = ref.greedy_descent_ref(rows, up, q, ep, ep_d,
                                    gather=ops.gather_distance, **kw)
    we, wd = ref.greedy_descent_ref(rows, up, q, ep, ep_d, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ge, le) and torch.equal(gd, ld), \
        f"{what}: the descent differs from the per-hop loop"
    same = ge == we
    frac = same.float().mean().item()
    err = (gd[same] - wd[same]).abs().max().item()
    assert frac >= 0.99, f"{what}: ep equal the plain version's on {frac}"
    assert err <= 1e-5, f"{what}: ep_dist err {err}"
    assert bool((ge != ep).any()), f"{what}: no query moved"
    return dict(max_abs_err=err, ep_equal_plain_frac=frac,
                equals_per_hop_loop=True)


def check_descent(torch, codec, rows, scales, q, ups) -> dict:
    """The one-launch greedy descent on ``rows`` (1M x 384 of ``codec``)
    in two cells (``DESCENT_CELLS``): the served search (B 8, M 16, the
    calls cycling over the 128 sets of 8 queries) and the bulk build's
    (B 1024, M 5), each on a random upper table [L, 1M, M]
    (``random_upper``), every query entering at row 0. Each cell holds
    ``descent_agree`` and times the descent (CUDA events a call), its
    plain version and the per-hop loop through the hop kernel (a launch,
    the PyTorch ops around it and a host read of the loop condition a
    hop: the parent's descent); the bound is the distinct lists and rows
    the traversal reads (+ q, ep, ep_dist in and out) over 3.35 TB/s, and
    ``hops_max`` the most hops a query takes, the chain of dependent
    reads."""
    from repro_torch.kernels import ops, ref

    cells = {}
    ep = torch.zeros(N_QUERIES, dtype=torch.int32, device=q.device)
    ep_d = ref.gather_distance_ref(rows, q, ep[:, None],
                                   scales=scales)[:, 0].contiguous()
    for name, (b, m) in DESCENT_CELLS.items():
        up = ups[m]
        layers = up.shape[0]
        sets = [slice(i, i + b) for i in range(0, N_QUERIES, b)]
        rec = descent_agree(torch, rows, scales, up, q, ep, ep_d,
                            f"greedy_descent {codec} {name}")
        first = {}
        ref.greedy_descent_ref(rows, up, q[sets[0]], ep[sets[0]],
                               ep_d[sets[0]], max_level=layers,
                               scales=scales, stats=first)
        nbytes = (first["lists"] * m * 4
                  + int(first["rows"].sum().item()) * row_bytes(rows, scales)
                  + b * (q.shape[1] * 4 + 16))
        per_elem = 2.0 if scales is None else 3.0
        b_ms, b_by = bound(nbytes, per_elem * first["pairs"] * q.shape[1])
        cyc = itertools.cycle(sets)

        def run(fn, **kw):
            def call():
                s = next(cyc)
                return fn(rows, up, q[s], ep[s], ep_d[s], max_level=layers,
                          scales=scales, **kw)
            return call

        reps = max(len(sets), 8)
        split = device_split(torch, run(ops.greedy_descent),
                             "greedy_descent_kernel", reps=reps)
        assert split["other_device_ms"] == 0, f"greedy_descent: {split}"
        rec.update(
            B=b, M=m, L=layers, **split,
            ms=time_ms(torch, run(ops.greedy_descent), reps),
            plain_ms=time_ms(torch, run(ref.greedy_descent_ref),
                             max(len(sets) // 8, 2), warmup=1),
            per_hop_loop_ms=time_ms(
                torch, run(ref.greedy_descent_ref, gather=ops.gather_distance),
                max(len(sets) // 8, 2), warmup=1),
            bound_ms=b_ms, bound_by=b_by,
            hops_max=int(first["hops"].max().item()),
            hops_total=int(first["hops"].sum().item()),
            lockstep_hops=first["lockstep_hops"], lists=first["lists"],
            rows=int(first["rows"].sum().item()), pairs=first["pairs"],
            plan=ops._descent_plan(q.shape[1], codec, m,
                                   ops._aligned16(rows)),
            shapes=f"vectors {rows.shape[0]}x{rows.shape[1]} {codec}"
                   + ("" if scales is None else " + scales")
                   + f", upper {layers}x{N_VECTORS}x{m} (10% -1), q {b}x"
                   f"{q.shape[1]}, entry row 0")
        cells[name] = rec
        log(f"greedy_descent {codec} {name} " + json.dumps(rec))
    first = next(iter(cells))
    return dict(cells[first], library_ms=None, library="none", cells=cells)


def beam_agree(torch, ki, kd, ri, rd, what: str) -> dict:
    """The kernel's (ids, dists) against the plain version's: ids equal on
    >= 99 % of queries, recall@10 against them >= 0.999, distances within
    1e-5 where the ids agree."""
    same = (ki == ri).all(dim=1)
    frac = same.float().mean().item()
    err = (kd[same] - rd[same]).abs().max().item()
    k = min(10, ki.shape[1])
    recall = (ki[:, :k, None] == ri[:, None, :k]).any(-1).float().mean().item()
    assert frac >= 0.99, f"{what}: ids equal on {frac} of rows"
    assert err <= 1e-5, f"{what}: dist err {err}"
    assert recall >= 0.999, f"{what}: recall@10 {recall}"
    return dict(max_abs_err=err, ids_equal_rows=frac, recall_at_10=recall)


def beam_work(rows, scales, m2: int, b: int, ef: int,
              seen: list[dict]) -> dict:
    """The work of one call from the plain version's traversal of its
    queries (``seen``: one record a call, averaged): the distinct-bytes
    bound (distinct rows + scales and lists, q, ep and ep_dist, the
    output, each once; one multiply-add a pair element, plus the decode
    multiply under int8) and the pair-bytes floor (every (query, row)
    distance's row read once: no reuse across queries)."""
    n = len(seen)
    n_rows = sum(int(v["rows"].sum().item()) for v in seen) / n
    n_lists = sum(int(v["lists"].sum().item()) for v in seen) / n
    pairs = sum(v["pairs"] for v in seen) / n
    per_elem = 2.0 if scales is None else 3.0
    d = rows.shape[1]
    b_ms, b_by = bound(n_rows * row_bytes(rows, scales) + n_lists * m2 * 4
                       + b * d * 4 + b * 8 + b * ef * 8,
                       per_elem * pairs * d)
    return dict(bound_ms=b_ms, bound_by=b_by,
                pair_floor_ms=pairs * row_bytes(rows, scales)
                / HBM_BYTES_PER_S * 1e3,
                distinct_rows=n_rows, distinct_lists=n_lists,
                query_row_pairs=pairs)


def beam_plan(codec, b: int, d: int, m2: int, ef: int, t: int) -> dict:
    """The block plan of a launch (threads, ring rows = rows in flight a
    block, shared bytes) and the blocks resident an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    from repro_torch.kernels import ops

    info = ops.beam_search_info(b, d, codec, m2, ef, t)
    assert info["kernel_shared_bytes"] == info["shared_bytes"], info
    info.pop("kernel_shared_bytes")
    return info


def check_beam(torch, codec, rows, scales, nbrs, q, ep, irows, iscales,
               qint) -> dict:
    """``beam_search`` on ``rows`` (1M x 384 of ``codec``) against its plain
    version (``beam_agree``; on integer-valued l2 rows ids and distances
    exactly equal) in three cells: B 1024 at T 4 and 1, ef 64; the served
    tick, B 8, ef 64, T 4, the calls cycling over the 128 disjoint sets of
    8 of the 1,024 queries so that each finds its rows cold; and, for
    int8, the bulk build's launch, B 1024, ``nbrs[:, :10]`` (M 5), ef 20,
    T 4. Each cell: ms, plain_ms, the bound and the pair-bytes floor
    (``beam_work``), the hop count and the block plan (``beam_plan``)."""
    from repro_torch.kernels import ops, ref

    ep_d = ref.gather_distance_ref(rows, q, ep[:, None],
                                   scales=scales)[:, 0].contiguous()
    ep_di = ref.gather_distance_ref(irows, qint, ep[:, None], metric="l2",
                                    scales=iscales)[:, 0].contiguous()
    cname = ops.CODEC_OF[rows.dtype]
    cells = [("t4", nbrs, EF, 4, N_QUERIES), ("t1", nbrs, EF, 1, N_QUERIES),
             ("served", nbrs, EF, 4, SERVED_B)]
    if codec == "int8":
        cells.append(("build", nbrs[:, :BUILD_M2].contiguous(), BUILD_EF, 4,
                      N_QUERIES))
    beam = {}
    for cell, graph, ef, t, b in cells:
        m2 = graph.shape[1]
        kw = dict(ef=ef, expand_t=t, scales=scales)
        ikw = dict(ef=ef, expand_t=t, scales=iscales, metric="l2")
        sets = [slice(i, i + b) for i in range(0, N_QUERIES, b)]
        ki, kd = (torch.cat(x) for x in zip(*[
            ops.beam_search(rows, graph, q[s], ep[s], ep_d[s], **kw)
            for s in sets]))
        ri, rd = ref.beam_search_ref(rows, graph, q, ep, ep_d, **kw)
        ki2, kd2 = (torch.cat(x) for x in zip(*[
            ops.beam_search(irows, graph, qint[s], ep[s], ep_di[s], **ikw)
            for s in sets]))
        ri2, rd2 = ref.beam_search_ref(irows, graph, qint, ep, ep_di, **ikw)
        torch.cuda.synchronize()
        what = f"beam_search {codec} {cell}"
        rec = beam_agree(torch, ki, kd, ri, rd, what)
        assert bool((ki2 == ri2).all()), f"{what} l2: ids differ"
        assert bool((kd2 == rd2).all()), f"{what} l2: dists differ"
        # the plain version's traversal of each call's queries says what
        # work a call needs
        seen = [ref.beam_search_ref(rows, graph, q[s], ep[s], ep_d[s],
                                    return_visited=True, **kw)[2]
                for s in sets]
        cyc = itertools.cycle(sets)

        def kernel():
            s = next(cyc)
            return ops.beam_search(rows, graph, q[s], ep[s], ep_d[s], **kw)

        def plain():
            s = next(cyc)
            return ref.beam_search_ref(rows, graph, q[s], ep[s], ep_d[s],
                                       **kw)

        rec.update(
            int_l2_exact=True, B=b, m2=m2, ef=ef, T=t,
            hops=ref.beam_schedule(ef, t, None)[2],
            ms=time_ms(torch, kernel, max(10, len(sets))),
            plain_ms=time_ms(torch, plain, 16 if b < N_QUERIES else 2,
                             warmup=1),
            **beam_work(rows, scales, m2, b, ef, seen),
            plan=beam_plan(cname, b, rows.shape[1], m2, ef, min(t, ef)))
        beam[cell] = rec
        log(f"{what} " + json.dumps(rec))
    return dict(
        beam["t4"], library_ms=None, library="none",
        **{c: beam[c] for c in beam if c != "t4"},
        shapes=f"vectors {rows.shape[0]}x{rows.shape[1]} {codec}"
               + ("" if scales is None else " + scales")
               + f", neighbors0 {nbrs.shape[0]}x{M2} (10% -1), "
               f"B {q.shape[0]}, ef {EF}, T 4 (t1: T 1; served: B "
               f"{SERVED_B}, 128 query sets cycled; build: neighbors0"
               f"[:, :{BUILD_M2}], ef {BUILD_EF})")


def check_wide(torch, codec, rows, scales, up, nbrs, q, irows, iscales,
               qint) -> tuple[dict, dict]:
    """A search past M 128 on ``rows`` (1M x 384 of ``codec``): the
    descent on the upper table ``up`` [2, 1M, 200] and the beam (ef 64, T
    4: 1,600 candidates a hop, two waves) on the layer-0 graph ``nbrs``
    [1M, 400], each at the served B 8, the calls cycling over the 128
    sets of 8 queries, every query entering at row 0. Held, over the
    1,024 queries: the descent bit for bit against the per-hop loop and
    against the plain version (``descent_agree``); the beam from the
    descent's entry points against its plain version (``beam_agree``);
    on integer-valued l2 rows both exactly. Each: ms (CUDA events a
    call), device ms a launch (profiler), the plain version's ms, the
    bound and the block plan."""
    from repro_torch.kernels import ops, ref

    layers, m2 = up.shape[0], nbrs.shape[1]
    dev = q.device
    b = SERVED_B
    sets = [slice(i, i + b) for i in range(0, N_QUERIES, b)]
    ep = torch.zeros(N_QUERIES, dtype=torch.int32, device=dev)
    ep_d = ref.gather_distance_ref(rows, q, ep[:, None],
                                   scales=scales)[:, 0].contiguous()
    what = f"{codec} M {WIDE_M}"
    desc = descent_agree(torch, rows, scales, up, q, ep, ep_d,
                         f"greedy_descent {what}")
    kw = dict(max_level=layers, scales=scales)
    de, dd = (torch.cat(x) for x in zip(*[
        ops.greedy_descent(rows, up, q[s], ep[s], ep_d[s], **kw)
        for s in sets]))
    bkw = dict(ef=EF, expand_t=4, scales=scales)
    ki, kd = (torch.cat(x) for x in zip(*[
        ops.beam_search(rows, nbrs, q[s], de[s], dd[s], **bkw)
        for s in sets]))
    ri, rd = ref.beam_search_ref(rows, nbrs, q, de, dd, **bkw)
    torch.cuda.synchronize()
    beam = beam_agree(torch, ki, kd, ri, rd, f"beam_search {what}")
    # integer-valued l2 rows: both exact against the plain version
    ikw = dict(max_level=layers, metric="l2", scales=iscales)
    ie_d = ref.gather_distance_ref(irows, qint, ep[:, None], metric="l2",
                                   scales=iscales)[:, 0].contiguous()
    ge, gd = (torch.cat(x) for x in zip(*[
        ops.greedy_descent(irows, up, qint[s], ep[s], ie_d[s], **ikw)
        for s in sets]))
    we, wd = ref.greedy_descent_ref(irows, up, qint, ep, ie_d, **ikw)
    ibkw = dict(ef=EF, expand_t=4, metric="l2", scales=iscales)
    ki2, kd2 = (torch.cat(x) for x in zip(*[
        ops.beam_search(irows, nbrs, qint[s], ge[s], gd[s], **ibkw)
        for s in sets]))
    ri2, rd2 = ref.beam_search_ref(irows, nbrs, qint, ge, gd, **ibkw)
    torch.cuda.synchronize()
    assert torch.equal(ge, we) and torch.equal(gd, wd), \
        f"greedy_descent {what} l2: differs from the plain version"
    assert torch.equal(ki2, ri2) and torch.equal(kd2, rd2), \
        f"beam_search {what} l2: differs from the plain version"

    first = {}
    ref.greedy_descent_ref(rows, up, q[sets[0]], ep[sets[0]], ep_d[sets[0]],
                           stats=first, **kw)
    b_ms, b_by = bound(first["lists"] * WIDE_M * 4
                       + int(first["rows"].sum().item())
                       * row_bytes(rows, scales) + b * (q.shape[1] * 4 + 16),
                       (2.0 if scales is None else 3.0) * first["pairs"]
                       * q.shape[1])
    cyc = itertools.cycle(sets)

    def descend(fn):
        def call():
            s = next(cyc)
            return fn(rows, up, q[s], ep[s], ep_d[s], **kw)
        return call

    split = device_split(torch, descend(ops.greedy_descent),
                         "greedy_descent_kernel", reps=len(sets))
    assert split["other_device_ms"] == 0, f"greedy_descent {what}: {split}"
    desc.update(
        B=b, M=WIDE_M, L=layers, int_l2_exact=True, **split,
        ms=time_ms(torch, descend(ops.greedy_descent), len(sets)),
        plain_ms=time_ms(torch, descend(ref.greedy_descent_ref), 8,
                         warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        hops_max=int(first["hops"].max().item()),
        plan=ops._descent_plan(q.shape[1], codec, WIDE_M,
                               ops._aligned16(rows)))
    log(f"greedy_descent {what} " + json.dumps(desc))

    seen = [ref.beam_search_ref(rows, nbrs, q[s], de[s], dd[s],
                                return_visited=True, **bkw)[2]
            for s in sets[:16]]

    def searched(fn):
        def call():
            s = next(cyc)
            return fn(rows, nbrs, q[s], de[s], dd[s], **bkw)
        return call

    split = device_split(torch, searched(ops.beam_search),
                         "beam_search_kernel", reps=len(sets))
    beam.update(
        int_l2_exact=True, B=b, m2=m2, ef=EF, T=4, **split,
        hops=ref.beam_schedule(EF, 4, None)[2],
        ms=time_ms(torch, searched(ops.beam_search), len(sets)),
        plain_ms=time_ms(torch, searched(ref.beam_search_ref), 8,
                         warmup=1),
        **beam_work(rows, scales, m2, b, EF, seen),
        plan=beam_plan(codec, b, rows.shape[1], m2, EF, 4),
        shapes=f"vectors {rows.shape[0]}x{rows.shape[1]} {codec}"
               + ("" if scales is None else " + scales")
               + f", upper {layers}x{N_VECTORS}x{WIDE_M}, neighbors0 "
               f"{N_VECTORS}x{m2} (10% -1), B {b}, 128 query sets cycled")
    log(f"beam_search {what} " + json.dumps(beam))
    return desc, beam


def ptxas_report(name: str) -> list[str]:
    """Registers, stack and spills of each kernel of ``name``'s build, as
    ``nvcc -Xptxas -v`` reported them (build/torch_kernels/<name>.log)."""
    from repro_torch.kernels import build

    log_file = build.BUILD_DIR / f"{name}.log"
    if not log_file.is_file():         # built by an earlier run
        return [f"no build log at {log_file}"]
    out, entry = [], None
    for line in log_file.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and ("registers" in line or "spill" in line):
            out.append(f"{entry[-40:]}: {line.strip()}")
    return out


def phase_kernels(torch, gen) -> dict:
    """Each kernel against its plain version at the main path's sizes:
    (a) ``gather_distance``, the descent and ``beam_search``, whose
    sources compile first; ``phase_kernels_late`` holds the rest, after
    phase 5, which runs while the longer sources compile. ``gen`` draws
    the inputs of both, in this order."""
    dev = torch.device("cuda")
    out = {}

    def unit(x):
        return x / x.norm(dim=-1, keepdim=True)

    vec = unit(torch.randn(N_VECTORS, DIM, device=dev, generator=gen))
    q = unit(torch.randn(N_QUERIES, DIM, device=dev, generator=gen))

    # -- gather_distance, the descent and beam_search, per row codec -----
    nbrs = torch.randint(0, N_VECTORS, (N_VECTORS, M2), device=dev,
                         generator=gen, dtype=torch.int32)
    pad = torch.rand(N_VECTORS, M2, device=dev, generator=gen) < 0.1
    nbrs = torch.where(pad, -1, nbrs).contiguous()           # -1 padding
    ep = torch.randint(0, N_VECTORS, (N_QUERIES,), device=dev, generator=gen,
                       dtype=torch.int32)
    # integer-valued rows with l2: exact arithmetic, so ids must match
    vint = torch.randint(-3, 4, (N_VECTORS, DIM), device=dev,
                         generator=gen).float()
    qint = torch.randint(-3, 4, (N_QUERIES, DIM), device=dev,
                         generator=gen).float()
    del pad
    ups = {m: random_upper(torch, gen, m) for _, m in DESCENT_CELLS.values()}
    wide_up = random_upper(torch, gen, WIDE_M)
    wide_nbrs = torch.randint(0, N_VECTORS, (N_VECTORS, 2 * WIDE_M),
                              device=dev, generator=gen, dtype=torch.int32)
    wide_nbrs[torch.rand(N_VECTORS, 2 * WIDE_M, device=dev,
                         generator=gen) < 0.1] = -1
    for codec in CODECS:
        rows, scales = encode_rows(torch, vec, codec)
        irows, iscales = encode_rows(torch, vint, codec, integer=True)
        out[f"gather_distance.{codec}"] = check_gather(
            torch, codec, rows, scales, q, gen)
        out[f"greedy_descent.{codec}"] = check_descent(
            torch, codec, rows, scales, q, ups)
        out[f"beam_search.{codec}"] = check_beam(
            torch, codec, rows, scales, nbrs, q, ep, irows, iscales, qint)
        if codec in WIDE_CODECS:
            (out[f"greedy_descent.{codec}"][f"m{WIDE_M}"],
             out[f"beam_search.{codec}"][f"m{WIDE_M}"]) = check_wide(
                torch, codec, rows, scales, wide_up, wide_nbrs, q, irows,
                iscales, qint)
        del rows, scales, irows, iscales
        torch.cuda.empty_cache()
    del nbrs, vec, q, vint, qint, ups, wide_up, wide_nbrs
    torch.cuda.empty_cache()
    return out


def phase_kernels_late(torch, gen) -> dict:
    """Phase 2 (b): ``flash_decode``, ``distance_topk`` and
    ``embedding_bag`` against their plain versions."""
    dev = torch.device("cuda")
    out = {"flash_decode": check_flash_decode(torch, dev, gen)}
    out.update(check_distance_topk(torch, dev, gen))
    out.update(check_embedding_bag(torch, dev, gen))
    return out


def flash_bound(cur_len: list[int], b: int, h: int, kvh: int,
                dh: int, elem: int = 4) -> tuple[float, str]:
    """``op_analysis.flash_decode_work``: live K and V rows and q of
    ``elem`` bytes an element, the fp32 output once each, cur_len; 4 H Dh
    flops a live position at the fp32 rate (the CUDA cores; 2-byte
    elements are widened)."""
    from repro_torch.launch.op_analysis import flash_decode_work

    nbytes, flops = flash_decode_work(b, h, kvh, dh, sum(cur_len), elem)
    return bound(nbytes, flops["fp32"])


def check_flash_decode(torch, dev, gen) -> dict:
    """``flash_decode`` in three cells of the llama3-8b decode geometry
    (H 32, KVH 8, Dh 128): B 8 at S 8192 with ragged lengths, B 8 with
    every row at 8192, and the served cache (slots x max_len, each slot
    at its own depth) with one cache per layer, the timed calls cycling
    through the 32 as a decode tick does (one layer's cache fits L2,
    the tick's do not); and the wide-head kernel at the same head counts,
    B 8, S 1,024, Dh 2,048 (``flash_cell``, fp32). The record is the
    ragged cell's, with every cell beside it."""
    cells = {name: flash_cell(torch, name, b, s, lens, layers, DEC_H,
                              DEC_KVH, dh, gen, torch.float32)
             for name, (b, s, lens, layers, dh) in FLASH_CELLS.items()}
    return dict(cells["ragged"], cells=cells)


def flash_cell(torch, name: str, b: int, s: int, lens: list[int],
               layers: int, h: int, kvh: int, dh: int, gen,
               dtype) -> dict:
    """One ``flash_decode`` cell on q/K/V of ``dtype`` (fp32 or bf16):
    ``layers`` caches cycled, the kernel against its plain version on
    every one (2e-5), CUDA-event ms of the kernel, the plain version and
    SDPA at ``dtype``, the bound of the cache's bytes, a profiler split
    holding one launch a call and no other kernel, and the device ms
    queued behind a spin kernel."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    codec = ops.FLASH_CODEC_OF[dtype]
    cur = torch.tensor(lens, dtype=torch.int32, device=dev)
    qd = torch.randn(b, h, dh, device=dev, generator=gen).to(dtype)
    kv = [(torch.randn(b, s, kvh, dh, device=dev, generator=gen).to(dtype),
           torch.randn(b, s, kvh, dh, device=dev, generator=gen).to(dtype))
          for _ in range(layers)]
    mask = (torch.arange(s, device=dev)[None, :]
            < cur[:, None])[:, None, None, :]                # [B,1,1,S]
    err = lib_err = 0.0
    for kd, vd in kv:
        got = ops.flash_decode(qd, kd, vd, cur)
        want = ref.flash_decode_ref(qd, kd, vd, cur)
        lib = F.scaled_dot_product_attention(
            qd[:, :, None, :], kd.transpose(1, 2), vd.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)[:, :, 0]
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        err = max(err, (got - want).abs().max().item())
        lib_err = max(lib_err, (lib.float() - want).abs().max().item())
    assert err <= 2e-5, f"flash_decode {codec} {name}: max abs err {err}"
    turn = itertools.count()

    def cycled(fn):
        def run():
            kd, vd = kv[next(turn) % layers]
            return fn(kd, vd)
        return run

    kernel = cycled(lambda kd, vd: ops.flash_decode(qd, kd, vd, cur))
    split = device_split(torch, kernel, "flash_decode", reps=max(8, layers))
    assert split["kernel_launches_traced"] <= 1 and \
        split["other_device_ms"] == 0, f"flash_decode {codec} {name}: {split}"
    b_ms, b_by = flash_bound(lens, b, h, kvh, dh, elem=qd.element_size())
    rec = dict(
        max_abs_err=err, ms=time_ms(torch, kernel, max(50, layers)),
        queued_ms=queued_ms(torch, kernel, max(50, layers)),
        plain_ms=time_ms(torch, cycled(
            lambda kd, vd: ref.flash_decode_ref(qd, kd, vd, cur)), 20),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, cycled(
            lambda kd, vd: F.scaled_dot_product_attention(
                qd[:, :, None, :], kd.transpose(1, 2), vd.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)), 50),
        library_max_abs_err=lib_err, **split,
        shapes=f"B {b}, H {h}, KVH {kvh}, G {h // kvh}, Dh {dh}, S {s} "
               f"{codec}, cur_len {lens}, {layers} cache(s) cycled")
    log(f"flash_decode {codec} {name} " + json.dumps(rec))
    del kv, qd
    torch.cuda.empty_cache()
    return rec


def check_embedding_bag(torch, dev, gen) -> dict:
    """``embedding_bag`` at MIND's 1M x 64 table, fp32 and bf16, bags of
    L 50 at B 512 and 262,144, ``sum`` and ``mean``, with weights and
    without (the entry run's branch: w 1, ``mean`` divides by L), against
    its plain version (rtol 1e-5, atol 1e-5); integer-valued rows with 0/1
    weights exactly. Ids are uniform; the weights are a behaviour mask
    (each bag's first n_b members, n_b uniform in [1, L], the tail 0).
    Each cell: CUDA events a call, the profiler's device ms a launch, the
    plain version's and the library's ms, the bound (the distinct rows of
    weighted members) and the time to read every member's row (what the
    reference's 0 x row semantics reads) at 3.35 TB/s."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    table32 = torch.randn(BAG_ROWS, BAG_DIM, device=dev, generator=gen)
    tint32 = torch.randint(-8, 9, (BAG_ROWS, BAG_DIM), device=dev,
                           generator=gen).float()
    pos = torch.arange(BAG_LEN, device=dev)
    recs = {}
    for b in BAG_BATCHES:
        # B 512 rows fit the 50 MB L2: timed calls cycle over 8 bag sets
        sets = []
        for _ in range(8 if b == BAG_BATCHES[0] else 1):
            ids = torch.randint(0, BAG_ROWS, (b, BAG_LEN), device=dev,
                                generator=gen, dtype=torch.int32)
            n_b = torch.randint(1, BAG_LEN + 1, (b, 1), device=dev,
                                generator=gen)
            sets.append((ids, (pos[None, :] < n_b).float().contiguous()))
        ids, w = sets[0]
        live = w > 0
        # work of this run's data: the distinct rows and members each
        # weighting reads (the mask's zero tail is still read and summed
        # by the kernel, but bounds count what the function needs)
        work = {"mask": (torch.unique(ids[live]).numel(),
                         int(live.sum().item()), 8),
                "none": (torch.unique(ids).numel(), ids.numel(), 4)}
        for dtype, tname in ((torch.float32, "fp32"),
                             (torch.bfloat16, "bf16")):
            table = table32.to(dtype)
            tint = tint32.to(dtype)
            for wk in ("mask", "none"):
                wi = w if wk == "mask" else None
                for combine in ("sum", "mean"):
                    if combine == "sum":
                        # 0/1 weights on integer rows: every partial sum
                        # is an exact integer (a mean is not: PyTorch
                        # divides by a scalar as a product with its
                        # reciprocal, the kernel divides)
                        got = ops.embedding_bag(tint, ids, wi,
                                                combine=combine)
                        want = ref.embedding_bag_ref(tint, ids, wi,
                                                     combine=combine)
                        torch.cuda.synchronize()
                        assert torch.equal(got, want), \
                            (f"embedding_bag {tname} B={b} {combine} "
                             f"w={wk}: integer rows differ")
                    got = ops.embedding_bag(table, ids, wi, combine=combine)
                    want = ref.embedding_bag_ref(table, ids, wi,
                                                 combine=combine)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got, want, rtol=1e-5,
                                               atol=1e-5)
                    err = (got - want).abs().max().item()
                    n_rows, members, id_bytes = work[wk]
                    b_ms, b_by = bound(
                        n_rows * BAG_DIM * table.element_size()
                        + ids.numel() * id_bytes + b * BAG_DIM * 4,
                        2.0 * members * BAG_DIM)
                    cyc = itertools.cycle(sets)

                    def kernel():
                        i, ww = next(cyc)
                        return ops.embedding_bag(
                            table, i, ww if wk == "mask" else None,
                            combine=combine)

                    def plain():
                        i, ww = next(cyc)
                        return ref.embedding_bag_ref(
                            table, i, ww if wk == "mask" else None,
                            combine=combine)

                    library_ms = lib_err = None
                    # one PyTorch call computes this function on the fp32
                    # table (not bf16: it would sum in bf16), with the
                    # weights only for sum (mode="mean" takes none)
                    if dtype == torch.float32 and (combine == "sum"
                                                   or wk == "none"):
                        def library():
                            i, ww = next(cyc)
                            return F.embedding_bag(
                                i, table, mode=combine,
                                per_sample_weights=(ww if wk == "mask"
                                                    else None))

                        lib_err = (F.embedding_bag(ids, table, mode=combine,
                                                   per_sample_weights=wi)
                                   - want).abs().max().item()
                        library_ms = time_ms(torch, library, 20)
                    # a call at B 512 is mostly the wrapper's host time;
                    # the profiler's time a launch is the kernel's
                    split = device_split(torch, kernel,
                                         "embedding_bag_kernel",
                                         reps=32 if b == BAG_BATCHES[0]
                                         else 8)
                    assert split["other_device_ms"] == 0, \
                        f"embedding_bag {tname} B={b}: {split}"
                    key = (tname, b, combine, wk)
                    recs[key] = dict(
                        max_abs_err=err, int_rows_exact=combine == "sum",
                        ms=time_ms(torch, kernel, 20), **split,
                        plain_ms=time_ms(torch, plain, 5, warmup=1),
                        bound_ms=b_ms, bound_by=b_by,
                        every_row_ms=ids.numel() * BAG_DIM
                        * table.element_size() / HBM_BYTES_PER_S * 1e3,
                        library_ms=library_ms,
                        library_max_abs_err=lib_err, distinct_rows=n_rows,
                        weighted_members=members,
                        splits=ops._bag_plan(b, BAG_LEN, BAG_DIM,
                                             torch.cuda.get_device_properties(
                                                 0).multi_processor_count))
                    log(f"embedding_bag {tname} B={b} {combine} w={wk} "
                        + json.dumps(recs[key]))
            del table, tint
        del sets, ids, w, live
        torch.cuda.empty_cache()
    # one record per table dtype, headed by its serve_bulk masked sum
    # cell, with every cell beside
    head = (BAG_BATCHES[-1], "sum", "mask")
    out = {}
    for t in ("fp32", "bf16"):
        out[f"embedding_bag.{t}"] = dict(
            recs[(t, *head)],
            library=("torch.nn.functional.embedding_bag(mode=combine, "
                     "per_sample_weights=w) on the fp32 table"
                     if t == "fp32" else "none: PyTorch's embedding_bag "
                     "sums a bf16 table in bf16, another function"),
            shapes=f"table {BAG_ROWS}x{BAG_DIM} {t}, ids [B, {BAG_LEN}] "
                   "uniform, weights a behaviour mask or None; head: B "
                   f"{head[0]} {head[1]} w={head[2]}",
            cells={f"B{b} {c} w={wk}": recs[(t, b, c, wk)]
                   for b in BAG_BATCHES for c in ("sum", "mean")
                   for wk in ("mask", "none")})
    del table32, tint32
    torch.cuda.empty_cache()
    return out


def bag_entry_run(torch) -> dict:
    """The kernel's own entry point, counted: ``ops.embedding_bag`` once
    per table dtype at MIND serve_p99 (B 512, L 50, sum, no weights),
    counters zeroed just before and read just after; each output held
    against the plain version (rtol 1e-5, atol 1e-5)."""
    from repro_torch.core import dispatch
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    table = torch.randn(BAG_ROWS, BAG_DIM, device=dev, generator=gen)
    ids = torch.randint(0, BAG_ROWS, (BAG_BATCHES[0], BAG_LEN), device=dev,
                        generator=gen, dtype=torch.int32)
    tables = (table, table.to(torch.bfloat16))
    dispatch.reset()
    outs = [ops.embedding_bag(t, ids) for t in tables]
    torch.cuda.synchronize()
    counts = dispatch.snapshot()
    for t, o in zip(tables, outs):
        assert o.shape == (BAG_BATCHES[0], BAG_DIM)
        torch.testing.assert_close(o, ref.embedding_bag_ref(t, ids),
                                   rtol=1e-5, atol=1e-5)
    return counts


def device_split(torch, fn, kernel: str, reps: int = 5) -> dict:
    """Device time of ``fn`` from a ``torch.profiler`` trace, split into
    the hand kernel (device functions whose name holds ``kernel``) and
    everything else (PyTorch's own kernels, such as a merge sort or
    gathers): ms per launch of the hand kernel, its launches per call as
    traced, and the other kernels' ms per call. The trace can drop a
    launch (kernel_launches_traced below the launches a call makes), so
    the time per launch is the number to read; calls are timed with CUDA
    events elsewhere."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hand = other = 0.0
    launches = 0
    for r in prof.key_averages():
        if r.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if kernel in r.key:
            hand += r.self_device_time_total
            launches += r.count
        else:
            other += r.self_device_time_total
    return {"kernel_ms_per_launch": hand / 1e3 / max(launches, 1),
            "kernel_launches_traced": launches / reps,
            "other_device_ms": other / 1e3 / reps}


def topk_bound(db, scales, b: int, k: int) -> tuple[float, str]:
    """``op_analysis.flat_topk_work``: each input read once (rows, scales,
    queries), each output written once (k f32 distances + k i32 ids per
    query). Operations: 2 B N D fp32 flops on the CUDA cores at B <= 8
    (the streaming path); above, the tensor-core path's split-TF32
    products, 3 x 2 B N D for fp32 rows and 2 x for bf16 and int8 rows
    (exact in TF32), at the TF32 rate."""
    from repro_torch.launch.op_analysis import flat_topk_work

    n, d = db.shape
    nbytes, flops = flat_topk_work(n, d, db.element_size(),
                                   scales is not None, b, k)
    if "tf32" in flops:
        return bound(nbytes, flops["tf32"], TF32_FLOPS_PER_S)
    return bound(nbytes, flops["fp32"])


def assert_topk_agree(torch, got, want, what: str) -> float:
    """Kernel (dists, ids) against the plain version's: distances within
    1e-5 everywhere, and ids equal wherever the two distances are not
    tied to 1e-6 (two rows that close may swap under another summation
    order) -> the share of queries whose ids are all equal."""
    (kd, ki), (rd, ri) = got, want
    torch.cuda.synchronize()
    err = (kd - rd).abs()
    assert err.max().item() <= 1e-5, f"{what}: err {err.max().item()}"
    assert bool(((ki == ri) | (err <= 1e-6)).all()), f"{what}: ids differ"
    return (ki == ri).all(dim=1).float().mean().item()


def topk_variants(torch, db, scales, dbi, scl_i, qcos, qint) -> dict:
    """The kernel's other template instances on the same rows: the 64- and
    256-slot lists (k 40, the int8 over-fetch of k 10, and k 200), the ip
    metric, and scalar row loads (D 30: no codec's row is a whole number
    of 16 bytes) -> {case: share of queries with all ids equal}. Random
    rows as ``assert_topk_agree``; integer rows exactly equal."""
    from repro_torch.kernels import ops, ref

    n30, out = 100_003, {}
    cut = (slice(0, n30), slice(0, 30))
    db30 = db[cut].contiguous()
    dbi30 = dbi[cut].contiguous()
    sc30 = None if scales is None else scales[:n30].contiguous()
    sci30 = None if scl_i is None else scl_i[:n30].contiguous()
    assert not ops._aligned16(db30) and not ops._aligned16(dbi30)
    cases = [("cosine k40 B128", db, scales, qcos[128], "cosine", 40),
             ("ip k200 B1", db, scales, qcos[1], "ip", 200),
             ("D30 ip k40 B128", db30, sc30, qcos[128][:, :30].contiguous(),
              "ip", 40),
             ("D30 l2 k10 B1", db30, sc30, qcos[1][:, :30].contiguous(),
              "l2", 10)]
    for name, rows, sc, q, metric, k in cases:
        out[name] = assert_topk_agree(
            torch, ops.flat_topk(rows, q, k, metric=metric, scales=sc),
            ref.distance_topk_ref(rows, q, k, metric=metric, scales=sc),
            f"distance_topk {name}")
    for b, k in ((128, 40), (1, 200)):
        name = f"D30 integer l2 k{k} B{b}"
        q = qint[b][:, :30].contiguous()
        kd, ki = ops.flat_topk(dbi30, q, k, metric="l2", scales=sci30)
        rd, ri = ref.distance_topk_ref(dbi30, q, k, metric="l2",
                                       scales=sci30)
        torch.cuda.synchronize()
        assert bool((ki == ri).all()) and bool((kd == rd).all()), \
            f"distance_topk {name}: differ"
        out[name] = 1.0
    return out


def check_topk_big_k(torch, db, scales, xf, dbi, scl_i, qcos, qint) -> dict:
    """k 1000 at the served batch B 8 on the 1M rows: ceil(k / 256)
    passes of the kernel, each after the last (d, id) of the one before,
    held against the plain version (random rows as ``assert_topk_agree``;
    integer-valued l2 rows exactly, as a whole and pass by pass), timed
    beside ``torch.topk``."""
    from repro_torch.core import dispatch
    from repro_torch.kernels import ops, ref

    b, k = TOPK_BIG_B, TOPK_BIG_K
    q = qcos[b]
    dispatch.reset()
    got = ops.flat_topk(db, q, k, scales=scales)
    launches = dispatch.get("kernel.distance_topk")
    assert launches == -(-k // ops.TOPK_PASS_K), launches
    want = ref.distance_topk_ref(db, q, k, scales=scales)
    frac = assert_topk_agree(torch, got, want, f"distance_topk k {k}")
    kd, ki = ops.flat_topk(dbi, qint[b], k, metric="l2", scales=scl_i)
    rd, ri = ref.distance_topk_ref(dbi, qint[b], k, metric="l2",
                                   scales=scl_i)
    torch.cuda.synchronize()
    assert bool((ki == ri).all()) and bool((kd == rd).all()), \
        f"distance_topk k {k}: integer l2 rows differ"
    # each pass alone on the integer rows: the plain version after the
    # kernel's last (d, id) of the pass before (on random rows a boundary
    # distance differs from the plain version's in the last bits, which
    # moves a near-tied row across the boundary)
    for c0 in range(ops.TOPK_PASS_K, k, ops.TOPK_PASS_K):
        c1 = min(k, c0 + ops.TOPK_PASS_K)
        pd, pi = ref.distance_topk_ref(dbi, qint[b], c1 - c0, metric="l2",
                                       scales=scl_i,
                                       after=(kd[:, c0 - 1], ki[:, c0 - 1]))
        assert bool((ki[:, c0:c1] == pi).all()) and \
            bool((kd[:, c0:c1] == pd).all()), \
            f"distance_topk pass {c0}: integer l2 rows differ"
    b_ms, b_by = topk_bound(db, scales, b, k)
    return dict(
        k=k, B=b, launches_per_search=launches, ids_equal_rows=frac,
        max_abs_err=(got[0] - want[0]).abs().max().item(),
        int_l2_exact=True,
        ms=time_ms(torch, lambda: ops.flat_topk(db, q, k, scales=scales), 10),
        plain_ms=time_ms(torch, lambda: ref.distance_topk_ref(
            db, q, k, scales=scales), 3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: torch.topk(
            1.0 - q @ xf.T, k, dim=1, largest=False), 10),
        **device_split(torch, lambda: ops.flat_topk(
            db, q, k, scales=scales), "distance_topk"))


def check_distance_topk(torch, dev, gen) -> dict:
    """``distance_topk`` on the rows of a 1M x 384 ``FlatVectorIndex``
    under each codec (the index normalizes and encodes them with the
    port's codec), against its plain version: random cosine rows (ids
    equal on >= 99 % of queries, distances within 1e-5 where they are),
    integer-valued l2 rows (ids and distances exactly equal, ties
    included; int8 rows with scales 1.0), and a row count whose last row
    range holds fewer than k rows, each search one launch; then k 1000 at
    B 8 (four passes of 256), as ``assert_topk_agree`` on the random rows
    (1,000 neighbours hold near-ties that another summation order swaps)
    and exactly on the integer rows."""
    import numpy as np
    from repro_torch.core import dispatch
    from repro_torch.core.codec import device_rows, get_codec
    from repro_torch.core.flat import FlatVectorIndex
    from repro_torch.kernels import ops, ref

    k = TOPK_K
    x = torch.randn(N_VECTORS, DIM, device=dev, generator=gen)
    x = (x / x.norm(dim=-1, keepdim=True)).cpu().numpy()
    keys = [f"r{i}" for i in range(N_VECTORS)]
    rng = np.random.default_rng(3)
    xint = rng.integers(-3, 4, size=(N_VECTORS, DIM)).astype(np.float32)
    qint = {b: torch.from_numpy(rng.integers(-3, 4, size=(b, DIM)).astype(
        np.float32)).to(dev) for b in TOPK_BATCHES}
    qcos = {}
    for b in TOPK_BATCHES:
        qb = torch.randn(b, DIM, device=dev, generator=gen)
        qcos[b] = qb / qb.norm(dim=-1, keepdim=True)
    # row counts whose last row range (ops._topk_plan) holds 0 < r < k rows
    tails = {}
    for b in TOPK_BATCHES:
        n = N_VECTORS - 1000
        for _ in range(8):
            _, splits, rows = ops._topk_plan(b, n, dev)
            if 0 < n - (splits - 1) * rows < k:
                break
            n = (n // rows) * rows + 3
        tails[b] = (n, n - (splits - 1) * rows)
        assert 0 < tails[b][1] < k, tails
    recs = {}
    for codec in CODECS:
        t0 = time.perf_counter()
        idx = FlatVectorIndex(dtype=codec, device="cuda")
        idx.bulk_insert(keys, x)
        flat = idx._rows.pack()
        db, scales = flat.vectors, flat.scales
        block_bytes = idx._rows.device_block_bytes()
        ingest_s = time.perf_counter() - t0
        if codec == "int8":
            dbi = device_rows(xint.astype(np.int8), dev)
            scl_i = torch.ones(N_VECTORS, device=dev)
        else:
            dbi = device_rows(get_codec(codec).encode(xint)[0], dev)
            scl_i = None
        xf = db.float() if scales is None else db.float() * scales[:, None]
        for b in TOPK_BATCHES:
            q = qcos[b]
            dispatch.reset()
            kd, ki = ops.flat_topk(db, q, k, scales=scales)
            launches = dispatch.get("kernel.distance_topk")
            assert launches == 1, f"distance_topk {codec} B={b}: {launches}"
            rd, ri = ref.distance_topk_ref(db, q, k, scales=scales)
            torch.cuda.synchronize()
            same = (ki == ri).all(dim=1)
            frac = same.float().mean().item()
            err = (kd[same] - rd[same]).abs().max().item()
            assert frac >= 0.99, f"distance_topk {codec} B={b}: ids {frac}"
            assert err <= 1e-5, f"distance_topk {codec} B={b}: err {err}"
            # integer-valued l2 rows: exact, ties included; then the short
            # last range
            kd2, ki2 = ops.flat_topk(dbi, qint[b], k, metric="l2",
                                     scales=scl_i)
            rd2, ri2 = ref.distance_topk_ref(dbi, qint[b], k, metric="l2",
                                             scales=scl_i)
            n_t, last = tails[b]
            sl = None if scl_i is None else scl_i[:n_t]
            kd3, ki3 = ops.flat_topk(dbi[:n_t], qint[b], k, metric="l2",
                                     scales=sl)
            rd3, ri3 = ref.distance_topk_ref(dbi[:n_t], qint[b], k,
                                             metric="l2", scales=sl)
            torch.cuda.synchronize()
            for got, want, what in ((ki2, ri2, "l2 ids"),
                                    (kd2, rd2, "l2 dists"),
                                    (ki3, ri3, "tail ids"),
                                    (kd3, rd3, "tail dists")):
                assert bool((got == want).all()), \
                    f"distance_topk {codec} B={b}: {what} differ"
            assert int(ki3.max()) < n_t

            def library():
                return torch.topk(1.0 - q @ xf.T, k, dim=1, largest=False)

            b_ms, b_by = topk_bound(db, scales, b, k)
            recs[(codec, b)] = dict(
                launches_per_search=launches,
                max_abs_err=err, ids_equal_rows=frac,
                int_l2_exact=True, tail_rows=n_t, tail_last_range=last,
                ms=time_ms(torch, lambda: ops.flat_topk(db, q, k,
                                                        scales=scales), 20),
                plain_ms=time_ms(torch, lambda: ref.distance_topk_ref(
                    db, q, k, scales=scales), 3),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(torch, library, 10),
                **device_split(torch, lambda: ops.flat_topk(
                    db, q, k, scales=scales), "distance_topk"))
            log(f"distance_topk {codec} B={b} "
                + json.dumps(recs[(codec, b)]))
        recs[(codec, "big")] = check_topk_big_k(torch, db, scales, xf, dbi,
                                                scl_i, qcos, qint)
        log(f"distance_topk {codec} B={TOPK_BIG_B} k={TOPK_BIG_K} "
            + json.dumps(recs[(codec, "big")]))
        recs[codec] = dict(device_block_bytes=block_bytes,
                           ingest_and_pack_s=ingest_s,
                           variants=topk_variants(torch, db, scales, dbi,
                                                  scl_i, qcos, qint))
        log(f"distance_topk {codec} index " + json.dumps(recs[codec]))
        del idx, flat, db, scales, dbi, scl_i, xf
        torch.cuda.empty_cache()
    # one record per codec, headed by its B 1 cell, with both cells beside
    out = {}
    for c in CODECS:
        out[f"distance_topk.{c}"] = dict(
            recs[(c, 1)],
            library="torch.mm (TF32 off) + torch.topk on the decoded fp32 "
                    "rows: no single PyTorch call computes this function",
            shapes=f"db {N_VECTORS}x{DIM} {c} (rows of a FlatVectorIndex),"
                   f" k {k}, cosine; head: B 1",
            cells={**{f"B{b}": recs[(c, b)] for b in TOPK_BATCHES},
                   f"B{TOPK_BIG_B} k{TOPK_BIG_K}": recs[(c, "big")]},
            **recs[c])
    return out


def served_run(torch, index_args: list[str], cfg=None):
    """One full-width served run through launch.serve.run (of ``cfg``,
    default llama3-8b's published config), the kernel counters zeroed
    just before and read just after. Returns (cfg, args, corpus, result,
    record)."""
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch
    from repro_torch.data.corpus import BUILTIN_CORPUS
    from repro_torch.launch import serve

    cfg = cfg or get_config("llama3-8b").model
    args = serve.parse_args(
        ["--rag", *index_args, "--requests", "8", "--max-new", "16",
         "--slots", "4", "--max-len", "256", "--seed", "0",
         "--device", "cuda"])
    corpus = list(BUILTIN_CORPUS) + synthetic_corpus(SYNTHETIC_DOCS,
                                                     args.seed)
    log(f"serve {' '.join(index_args)}: {cfg.name} at full width, "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, fp32 random weights (seed {args.seed}); "
        f"{len(corpus)} documents")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dispatch.reset()
    res = serve.run(cfg, args, corpus=corpus)
    torch.cuda.synchronize()
    counts = dispatch.snapshot()
    wall = time.perf_counter() - t0
    reqs = res["reqs"]
    rec = dict(
        requests=len(reqs), tokens=res["tokens"], seconds=res["seconds"],
        req_per_s=len(reqs) / res["seconds"],
        tok_per_s=res["tokens"] / res["seconds"],
        setup_and_serve_s=wall,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        engine=res["engine"].stats.as_dict(),
        retrieval=res["rag"].retriever.stats.as_dict(), counters=counts)
    assert all(r.done and len(r.out_tokens) == args.max_new for r in reqs)
    return cfg, args, corpus, res, rec


def phase_serve(torch) -> dict:
    """The HNSW served path at full width, through launch.serve.run."""
    from repro_torch.core import hnsw as thnsw
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as tf

    cfg, args, _, res, serve_out = served_run(torch, ["--index", "hnsw"])
    eng, rag, reqs = res["engine"], res["rag"], res["reqs"]
    es, rs, counts = (serve_out["engine"], serve_out["retrieval"],
                      serve_out["counters"])
    serve_out["graph_max_level"] = rag.index.host_graph().max_level
    log("serve " + json.dumps(serve_out))

    # every kernel of the path launched during the served run
    for c in HNSW_PATH:
        assert counts.get(c, 0) > 0, f"{c} never launched on the served path"
    assert counts["kernel.flash_decode"] == cfg.n_layers * es["decode_ticks"]
    assert counts["kernel.beam_search"] == rs["searches"]
    # the upper layers descend in one launch a search, with no host sync
    assert serve_out["graph_max_level"] >= 1
    assert counts["hnsw.descent_launches"] == rs["searches"] \
        == counts["kernel.gather_distance"]
    assert counts.get("hnsw.host_syncs", 0) == 0

    # retrieved keys == the same host graph searched on the CPU (plain
    # versions of the kernels)
    idx = rag.index
    cpu_g = thnsw.to_device_graph(idx.host_graph(), idx._deleted,
                                  device="cpu")
    qv = rag.encoder.encode([r.query for r in reqs])
    ids, _ = thnsw.search_graph(cpu_g, qv, k=3, ef=idx.ef_search,
                                beam_impl=idx.beam_impl)
    want = [[idx._keys[i] for i in row if i >= 0] for row in ids.tolist()]
    got = [[d.key for d in r.docs] for r in reqs]
    assert got == want, f"served keys {got} != CPU search {want}"
    log(f"served keys equal the CPU search: {got}")

    # the recall oracle: exact_query on the card (the distance_topk
    # kernel) == exact_query of the same index on the CPU
    exact, _ = idx.exact_query(qv, k=3)
    on_cpu = copy.copy(idx)
    on_cpu.device = torch.device("cpu")
    exact_cpu, _ = on_cpu.exact_query(qv, k=3)
    assert exact == exact_cpu, f"exact_query {exact} != CPU {exact_cpu}"
    recall = sum(len(set(g) & set(e)) for g, e in zip(got, exact)) / sum(
        len(e) for e in exact)
    serve_out.update(exact_keys=exact, recall_at_3_vs_exact=recall)
    log(f"exact_query on the card equals the CPU's: {exact}; served HNSW "
        f"recall@3 against it {recall:.4f}")

    # flash_decode at the geometry the served run gave it (slots x max_len
    # cache, each slot at its own depth): the kernel against its plain
    # version on one layer's prefilled cache, its time cycling through the
    # model's layer caches as a tick does, then one full-width
    # decode_step, flash kernel vs the dense path
    model = eng.model
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (args.slots, args.max_len - 1),
                         device="cuda", generator=gen)
    lens = torch.tensor([1 + (args.max_len - 2) * i // (args.slots - 1)
                         for i in range(args.slots)], dtype=torch.int32,
                        device="cuda")
    _, cache = tf.prefill(model, toks, max_len=args.max_len, prompt_lens=lens)
    qf = torch.randn(args.slots, cfg.n_heads, cfg.dh, device="cuda",
                     generator=gen)
    got = ops.flash_decode(qf, cache.k[0], cache.v[0], lens + 1)
    want = ref.flash_decode_ref(qf, cache.k[0], cache.v[0], lens + 1)
    torch.cuda.synchronize()
    ferr = (got - want).abs().max().item()
    assert ferr <= 2e-5, f"flash_decode at the served shape: err {ferr}"
    live = lens + 1
    layer = itertools.count()

    def flash_tick(fn):
        def run():
            li = next(layer) % cfg.n_layers
            return fn(qf, cache.k[li], cache.v[li], live)
        return run

    flash_ms = time_ms(torch, flash_tick(ops.flash_decode), 4 * cfg.n_layers)
    flash_split = device_split(torch, flash_tick(ops.flash_decode),
                               "flash_decode", reps=cfg.n_layers)
    assert flash_split["kernel_launches_traced"] <= 1 and \
        flash_split["other_device_ms"] == 0, flash_split
    flash_plain_ms = time_ms(torch, flash_tick(ref.flash_decode_ref),
                             cfg.n_layers)
    nxt = toks[torch.arange(args.slots, device="cuda"), lens.long() - 1]
    logits = {}
    for impl in ("flash", "dense"):
        c = tf.KVCache(cache.k.clone(), cache.v.clone(), cache.cur_len.clone())
        logits[impl], _ = tf.decode_step(model, nxt[:, None], c,
                                         attn_impl=impl)
    lf, ld = logits["flash"].float(), logits["dense"].float()
    assert lf.shape == (args.slots, 1, cfg.vocab)
    assert bool(torch.isfinite(lf).all())
    torch.testing.assert_close(lf, ld, rtol=1e-3, atol=1e-3)
    assert bool((lf.argmax(-1) == ld.argmax(-1)).all())
    serve_out["flash_at_served_shape"] = dict(
        cache=f"{args.slots} x {args.max_len}", live=live.tolist(),
        kernel_vs_plain_max_abs_err=ferr, ms=flash_ms, **flash_split,
        plain_ms=flash_plain_ms,
        bound_ms=flash_bound(live.tolist(), args.slots, cfg.n_heads,
                             cfg.n_kv_heads, cfg.dh)[0],
        decode_step_flash_vs_dense_max_abs_diff=(lf - ld).abs().max().item())
    log("flash_decode at the served shape, kernel vs plain and decode_step "
        "flash vs dense (argmax equal) "
        + json.dumps(serve_out["flash_at_served_shape"]))
    serve_out["profile"] = profile_decode(torch, model, cfg, args)
    log("serve profile " + json.dumps(serve_out["profile"]))
    return serve_out


def phase_serve_flat(torch, exact_keys) -> dict:
    """The flat served path (int8 rows) at full width; then fp32 and bf16
    flat indexes of the same corpus, on the card against the CPU."""
    from repro_torch.core import dispatch
    from repro_torch.core.flat import FlatVectorIndex

    cfg, args, corpus, res, out = served_run(
        torch, ["--index", "flat", "--index-dtype", "int8"])
    log("serve flat " + json.dumps(out))
    counts, es, rs = out["counters"], out["engine"], out["retrieval"]
    for c in FLAT_PATH:
        assert counts.get(c, 0) > 0, f"{c} never launched on the flat path"
    assert counts["kernel.distance_topk"] == rs["searches"]
    assert counts["kernel.flash_decode"] == cfg.n_layers * es["decode_ticks"]
    rag, reqs = res["rag"], res["reqs"]
    got = [[d.key for d in r.docs] for r in reqs]
    qv = rag.encoder.encode([r.query for r in reqs])
    keys = [key for key, _ in corpus]
    vecs = rag.encoder.encode([text for _, text in corpus])
    out["overfetch"] = check_overfetch(torch, rag.index, qv, k=3)
    log("served index, over-fetched candidates, kernel == plain "
        + json.dumps(out["overfetch"]))
    del res, rag

    def flat_keys(dtype, device):
        idx = FlatVectorIndex(dtype=dtype, device=device)
        idx.bulk_insert(keys, vecs)
        return idx.query_batch(qv, k=3)[0]

    want = flat_keys("int8", "cpu")
    assert got == want, f"served flat keys {got} != CPU index {want}"
    out["keys"] = {"int8 served": got}
    for dtype in ("fp32", "bf16"):
        # each codec's own run of the flat path, counted
        dispatch.reset()
        card = flat_keys(dtype, "cuda")
        out[f"counters_{dtype}"] = dispatch.snapshot()
        cpu = flat_keys(dtype, "cpu")
        assert card == cpu, f"flat {dtype}: card {card} != CPU {cpu}"
        out["keys"][dtype] = card
    assert out["keys"]["fp32"] == exact_keys, \
        f"flat fp32 {out['keys']['fp32']} != HNSW exact_query {exact_keys}"
    log("flat keys (int8 served == CPU; fp32, bf16 card == CPU; fp32 == "
        "HNSW exact_query) " + json.dumps(out["keys"]))
    return out


def check_overfetch(torch, idx, qv, k: int) -> dict:
    """The kernel's k * rerank_factor candidates on the served index's
    packed rows, before the host rerank, against its plain version (as
    ``assert_topk_agree``)."""
    from repro_torch.core.codec import effective_rerank
    from repro_torch.kernels import ops, ref

    flat = idx._rows.pack()
    kk = k * effective_rerank(idx._codec, idx.rerank_factor)
    q = torch.as_tensor(qv, dtype=torch.float32, device="cuda")
    q = (q / torch.clamp_min(torch.linalg.vector_norm(
        q, dim=-1, keepdim=True), 1e-12)).contiguous()
    got = ops.flat_topk(flat.vectors, q, kk, metric=flat.metric,
                        scales=flat.scales)
    want = ref.distance_topk_ref(flat.vectors, q, kk, metric=flat.metric,
                                 scales=flat.scales)
    frac = assert_topk_agree(torch, got, want, "over-fetched candidates")
    return {"rows": flat.n, "queries": q.shape[0], "k": kk,
            "ids_equal_rows": frac,
            "max_abs_err": (got[0] - want[0]).abs().max().item()}


def phase_bulk(torch) -> dict:
    """The bulk builder on the card: (a) bit identity with the CPU on
    integer-valued l2 rows; (b) an int8 ``HNSW(use_bulk_build=True)`` at
    MeMemo's ``build_1m`` shape, its resident bytes, its ``query_batch``
    against a CPU search of the same host graph, its recall against
    ``exact_query``, and the bulk and sequential builders' recall on a
    prefix; (c) the device's busy share over a prefix build."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.mememo import CONFIG
    from repro_torch.core import dispatch
    from repro_torch.core import hnsw_build as tb
    from repro_torch.core.index import make_index

    out = {}
    # (a) integer-valued l2 rows: exact arithmetic, so the card's graph
    # must equal the CPU's bit for bit
    n, d = BULK_INT["rows"], BULK_INT["dim"]
    xi = np.random.default_rng(7).integers(-3, 4, size=(n, d)).astype(
        np.float32)
    kw = dict(M=BULK_INT["M"], ef_construction=BULK_INT["ef_construction"],
              batch_size=BULK_INT["batch_size"], metric="l2", seed=0)
    dispatch.reset()
    t0 = time.perf_counter()
    g_card = tb.bulk_build(xi, device="cuda", **kw)
    card_s = time.perf_counter() - t0
    counts = dispatch.snapshot()
    t0 = time.perf_counter()
    g_cpu = tb.bulk_build(xi, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    for name in ("neighbors0", "upper", "levels", "vectors"):
        assert np.array_equal(getattr(g_card, name), getattr(g_cpu, name)), \
            f"bulk_build on the card: {name} differs from the CPU's"
    assert (g_card.entry, g_card.max_level) == (g_cpu.entry, g_cpu.max_level)
    out["int_l2_bit_identical"] = dict(
        BULK_INT, card_s=card_s, cpu_s=cpu_s, max_level=g_card.max_level,
        beam_search_launches=counts["kernel.beam_search.fp32"],
        gather_distance_launches=counts["kernel.gather_distance.fp32"])
    log("bulk_build card == CPU bit for bit on integer l2 rows "
        + json.dumps(out["int_l2_bit_identical"]))
    del g_card, g_cpu, xi

    # (b) the paper's build: 1M x 384 cosine rows, M 5, efC 20, int8
    cfg = CONFIG.model
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(BULK_ROWS, cfg.dim, device="cuda", generator=gen)
    qs = torch.randn(BULK_QUERIES, cfg.dim, device="cuda",
                     generator=gen).cpu().numpy()
    x = x.cpu().numpy()
    keys = [f"v{i}" for i in range(BULK_ROWS)]
    idx = make_index("hnsw", dim=cfg.dim, metric=cfg.metric, M=cfg.M,
                     ef_construction=cfg.ef_construction,
                     ef_search=cfg.ef_search, use_bulk_build=True,
                     dtype="int8", device="cuda")
    dispatch.reset()
    t0 = time.perf_counter()
    idx.bulk_insert(keys, x)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_counts = dispatch.snapshot()
    batches = -(-(BULK_ROWS - 256) // 1024)
    dispatch.reset("hnsw.h2d_bytes")
    t0 = time.perf_counter()
    dg = idx._dg()                        # the resident int8 graph
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    nb = {name: t.numel() * t.element_size() for name, t in (
        ("vectors", dg.vectors), ("scales", dg.scales),
        ("neighbors0", dg.neighbors0), ("upper", dg.upper),
        ("levels", dg.levels), ("deleted", dg.deleted))}
    adjacency = nb["neighbors0"] + nb["upper"]
    assert dg.vectors.dtype == torch.int8
    assert nb["vectors"] + nb["scales"] == BULK_ROWS * (cfg.dim + 4)
    assert sum(nb.values()) == (BULK_ROWS * (cfg.dim + 4) + adjacency
                                + nb["levels"] + nb["deleted"])
    rec = dict(
        rows=BULK_ROWS, dim=cfg.dim, M=cfg.M,
        ef_construction=cfg.ef_construction, dtype="int8", batch_size=1024,
        bootstrap=256, batches=batches, build_s=build_s,
        build_s_per_batch=build_s / batches, rows_per_s=BULK_ROWS / build_s,
        build_h2d_bytes=build_counts["hnsw.h2d_bytes"],
        beam_search_launches=build_counts["kernel.beam_search"],
        gather_distance_launches=build_counts["kernel.gather_distance"],
        descent_launches=build_counts.get("hnsw.descent_launches", 0),
        host_syncs=build_counts.get("hnsw.host_syncs", 0),
        max_level=dg.max_level, upload_s=upload_s,
        upload_h2d_bytes=dispatch.get("hnsw.h2d_bytes"),
        resident_bytes=sum(nb.values()), resident_by_tensor=nb,
        rows_and_scales_bytes=nb["vectors"] + nb["scales"],
        adjacency_bytes=adjacency)
    assert rec["beam_search_launches"] == batches
    # one descent a batch's search, and no host sync in any search
    assert rec["descent_launches"] == batches == rec[
        "gather_distance_launches"]
    assert rec["host_syncs"] == 0
    log("bulk build, MeMemo build_1m in int8 " + json.dumps(rec))
    out["build_1m_int8"] = rec
    out["descent_1m_int8"] = check_built_descent(torch, dg, qs)

    # query_batch at ef 64, k 10 (over-fetch k * 4, host rerank), then the
    # same host graph searched on the CPU through the plain versions
    idx.query_batch(qs[:8], k=10, ef=64)                 # warm
    dispatch.reset()
    t0 = time.perf_counter()
    got, _ = idx.query_batch(qs, k=10, ef=64)
    query_s = time.perf_counter() - t0
    query_counts = dispatch.snapshot()
    on_cpu = copy.copy(idx)
    on_cpu.device = torch.device("cpu")
    on_cpu._device_graph = None
    want, _ = on_cpu.query_batch(qs[:BULK_SAMPLE], k=10, ef=64)
    same = sum(g == w for g, w in zip(got, want)) / BULK_SAMPLE
    assert same >= 0.99, f"1M int8 index: card == CPU on {same} of queries"
    exact, _ = idx.exact_query(qs, k=10)
    recall = sum(len(set(g) & set(e)) for g, e in zip(got, exact)) / (
        10 * len(exact))
    out["query_1m_int8"] = dict(
        queries=BULK_QUERIES, k=10, ef=64, over_fetch=40,
        wall_s=query_s, queries_per_s=BULK_QUERIES / query_s,
        counters=query_counts, cpu_sample=BULK_SAMPLE,
        keys_equal_cpu_rows=same, recall_at_10_vs_exact=recall)
    log("1M int8 query_batch " + json.dumps(out["query_1m_int8"]))
    out["build_counters"], out["query_counters"] = build_counts, query_counts
    del on_cpu, dg
    # (d) the durable store on this index, whose restore replaces the
    # build: snapshot + logged mutations, then the index is dropped and
    # the card's cache emptied, then the warm restore
    d = store_dir("store_1m")
    try:
        live = store_snapshot_and_mutate(idx, keys, x, qs, d)
        del idx
        live["left_on_card_gb"] = release(torch)
        assert live["left_on_card_gb"] < 0.5, "the live index is still held"
        out["store_1m_int8"] = store_restore(torch, live, qs, build_s, d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    out["compact_prefix"] = store_compact(torch, keys, x, qs)

    # what recall random 384-d rows allow at M 5: the bulk and the
    # sequential builder on a prefix, searched on the card, held to the
    # reference's criterion (tests/test_build.py: bulk >= sequential - 0.05)
    rq = {}
    for name, bulk in (("sequential", False), ("bulk", True)):
        idx = make_index("hnsw", dim=cfg.dim, metric=cfg.metric, M=cfg.M,
                         ef_construction=cfg.ef_construction,
                         use_bulk_build=bulk, device="cuda")
        t0 = time.perf_counter()
        idx.bulk_insert(keys[:QUALITY_ROWS], x[:QUALITY_ROWS])
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        got, _ = idx.query_batch(qs, k=10, ef=64)
        exact, _ = idx.exact_query(qs, k=10)
        rq[name] = dict(build_s=built, recall_at_10_vs_exact=sum(
            len(set(g) & set(e)) for g, e in zip(got, exact)) / (
                10 * len(exact)))
    assert (rq["bulk"]["recall_at_10_vs_exact"]
            >= rq["sequential"]["recall_at_10_vs_exact"] - 0.05), rq
    out["prefix_quality"] = dict(rows=QUALITY_ROWS, dtype="fp32", ef=64,
                                 **rq)
    log("bulk vs sequential builder on a prefix "
        + json.dumps(out["prefix_quality"]))
    del idx

    # (c) where a batch's time goes: a prefix build at the same widths,
    # timed, then traced -> the device's busy and idle share
    xp = x[:PROFILE_ROWS]
    pkw = dict(M=cfg.M, ef_construction=cfg.ef_construction, device="cuda")
    t0 = time.perf_counter()
    tb.bulk_build(xp, **pkw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tb.bulk_build(xp, **pkw)
        torch.cuda.synchronize()
    busy = sum(r.self_device_time_total for r in prof.key_averages()
               if r.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    top = sorted(((r.key, r.self_device_time_total / 1e3)
                  for r in prof.key_averages()
                  if r.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda kv: -kv[1])[:6]
    pb = -(-(PROFILE_ROWS - 256) // 1024)
    out["profile"] = dict(
        rows=PROFILE_ROWS, batches=pb, wall_s=wall,
        wall_s_per_batch=wall / pb, device_busy_s=busy,
        device_idle_share=1.0 - busy / wall, top_device_ms=dict(top))
    log("bulk build profile " + json.dumps(out["profile"]))
    return out


def check_built_descent(torch, dg, qs) -> dict:
    """The descent on the built 1M int8 index's resident graph and its
    1,024 queries (prepared as a search prepares them, entering at the
    graph's entry point): ``descent_agree``, and its time against the
    per-hop loop through the hop kernel."""
    from repro_torch.core import hnsw as thnsw
    from repro_torch.kernels import ops, ref

    q = thnsw._prep_queries(dg, qs)
    ep = torch.full((q.shape[0],), dg.entry, dtype=torch.int32,
                    device=q.device)
    ep_d = ref.gather_distance_ref(dg.vectors, q, ep[:, None], metric=dg.metric,
                                   scales=dg.scales)[:, 0].contiguous()
    up = dg.upper
    rec = descent_agree(torch, dg.vectors, dg.scales, up[:dg.max_level], q,
                        ep, ep_d, "greedy_descent on the built 1M int8 index")
    kw = dict(max_level=dg.max_level, metric=dg.metric, scales=dg.scales)
    rec.update(
        B=q.shape[0], M=up.shape[2], L=dg.max_level,
        ms=time_ms(torch, lambda: ops.greedy_descent(
            dg.vectors, up, q, ep, ep_d, **kw), 8),
        per_hop_loop_ms=time_ms(torch, lambda: ref.greedy_descent_ref(
            dg.vectors, up, q, ep, ep_d, gather=ops.gather_distance, **kw),
            2, warmup=1))
    log("greedy_descent on the built 1M int8 index " + json.dumps(rec))
    return rec


def store_dir(name: str) -> Path:
    """A fresh directory for a store under the checkout's gitignored
    ``build/scratch/``, with the disk's free space logged."""
    root = ROOT / "build" / "scratch"
    root.mkdir(parents=True, exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix=f"{name}_", dir=root))
    free = shutil.disk_usage(d).free / 1e9
    log(f"store dir {d}: {free:.1f} GB free")
    return d


def dir_bytes(d: Path) -> int:
    return sum(p.stat().st_size for p in d.rglob("*") if p.is_file())


def store_snapshot_and_mutate(idx, keys, x, qs, d: Path) -> dict:
    """Phase 5 (d), first half: attach an ``IndexStore`` in ``d`` to the
    1M x 384 int8 HNSW, snapshot it, and apply a few logged mutations.
    Each lossy sequential insert concatenates the whole encoded array
    (``HNSW._append_enc``), so they are kept few. Returns what the live
    index answers and holds, for the restore to be held against."""
    import numpy as np
    from repro_torch.store import IndexStore

    store = IndexStore(str(d))
    store.attach(idx)
    t0 = time.perf_counter()
    snap = store.snapshot(idx)
    snap_s = time.perf_counter() - t0
    n = len(keys)
    rng = np.random.default_rng(13)
    fresh = rng.normal(size=(STORE_INSERTS + STORE_UPDATES,
                             x.shape[1])).astype(np.float32)
    t0 = time.perf_counter()
    for j in range(STORE_INSERTS):
        idx.insert(f"new{j}", fresh[j])
    for j, r in enumerate(rng.choice(n, STORE_UPDATES, replace=False)):
        idx.update(keys[int(r)], fresh[STORE_INSERTS + j])
    deletes = 0
    for r in rng.choice(n, STORE_DELETES, replace=False):
        if keys[int(r)] in idx:
            idx.delete(keys[int(r)])
            deletes += 1
    mutate_s = time.perf_counter() - t0
    got, _ = idx.query_batch(qs, k=10, ef=64)
    arrays, meta = idx.state_dict()
    return dict(snapshot=snap, snapshot_s=snap_s, mutate_s=mutate_s,
                deletes=deletes, wal_bytes=store.wal.size_bytes, keys=got,
                epoch=idx.mutation_epoch, size=idx.size, arrays=arrays,
                meta=meta)


def store_restore(torch, live: dict, qs, build_s: float, d: Path) -> dict:
    """Phase 5 (d), second half: warm-restore the dropped index with
    ``make_index("hnsw", store=...)`` and hold it against the live one:
    the same keys on the 1,024 queries, the same ``mutation_epoch`` and
    equal ``state_dict`` arrays. The restore is timed apart as the
    snapshot read (a separate call), the rest of ``make_index`` (adopting
    the pages and replaying the WAL) and the first query's upload."""
    import numpy as np
    from repro_torch.core import dispatch
    from repro_torch.core.index import make_index
    from repro_torch.store import read_snapshot

    t0 = time.perf_counter()
    read_snapshot(live["snapshot"])
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = make_index("hnsw", store=str(d), device="cuda")
    restore_s = time.perf_counter() - t0
    assert restored._device_graph is None
    dispatch.reset("hnsw.h2d_bytes")
    t0 = time.perf_counter()
    restored._dg()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    upload_bytes = dispatch.get("hnsw.h2d_bytes")
    got, _ = restored.query_batch(qs, k=10, ef=64)
    assert restored.mutation_epoch == live["epoch"], "restored epoch differs"
    assert restored.size == live["size"]
    assert got == live["keys"], "restored index: keys differ from the live"
    arrays, meta = restored.state_dict()
    assert meta == live["meta"], "restored state_dict meta differs"
    assert set(arrays) == set(live["arrays"])
    for name, a in arrays.items():
        assert a.dtype == live["arrays"][name].dtype, name
        assert np.array_equal(a, live["arrays"][name]), \
            f"restored state_dict array {name} differs"
    snap_bytes = dir_bytes(Path(live["snapshot"]))
    rec = dict(
        nodes=len(live["meta"]["keys"]), live_rows=live["size"],
        dtype="int8",
        snapshot_s=live["snapshot_s"], snapshot_bytes=snap_bytes,
        snapshot_mb_per_s=snap_bytes / 1e6 / live["snapshot_s"],
        inserts=STORE_INSERTS, updates=STORE_UPDATES,
        deletes=live["deletes"], mutate_s=live["mutate_s"],
        wal_bytes=live["wal_bytes"],
        left_on_card_gb=live["left_on_card_gb"], restore_s=restore_s,
        snapshot_read_s=read_s, replay_and_adopt_s=restore_s - read_s,
        first_upload_s=upload_s, first_upload_h2d_bytes=upload_bytes,
        restore_total_s=restore_s + upload_s, bulk_build_s=build_s,
        build_over_restore=build_s / (restore_s + upload_s),
        epoch=live["epoch"], queries=len(qs), keys_equal_live=True,
        state_dict_arrays_equal=True, disk_bytes=dir_bytes(d))
    log("store on the 1M int8 index " + json.dumps(rec))
    return rec


def store_compact(torch, keys, x, qs) -> dict:
    """Phase 5 (e): compact with secure delete on a 2,500-row int8 prefix
    (``_compact_impl`` rebuilds sequentially, so not at 1M): no deleted
    row's encoded bytes, fp32 decode or raw payload, and no deleted key,
    in any file under the store dir; no deleted row's scale in the stored
    scale column beyond live rows that share its value; the compacted
    store restores with the live index's keys."""
    import numpy as np
    from repro_torch.core.index import make_index
    from repro_torch.store import read_snapshot

    n = COMPACT_ROWS
    d = store_dir("store_compact")
    try:
        idx = make_index("hnsw", store=str(d), M=5, ef_construction=20,
                         dtype="int8", use_bulk_build=True, device="cuda")
        idx.bulk_insert(keys[:n], x[:n])
        idx._store.snapshot(idx)
        rng = np.random.default_rng(14)
        rows = rng.choice(n, COMPACT_DELETES, replace=False)
        gone = [keys[int(r)] for r in rows]
        forms = []
        for r, k in zip(rows, gone):
            node = idx._key2id[k]
            forms.append((idx._enc[node].tobytes(),
                          idx._builder.vectors[node].tobytes(),
                          x[int(r)].tobytes(), float(idx._scales[node])))
            idx.delete(k)
        blob = b"".join(p.read_bytes() for p in d.rglob("*") if p.is_file())
        assert all(e in blob for e, *_ in forms)   # on disk before compact
        t0 = time.perf_counter()
        idx._store.compact(idx)
        compact_s = time.perf_counter() - t0
        files = [p for p in d.rglob("*") if p.is_file()]
        for p in files:
            data = p.read_bytes()
            for enc, dec, raw, _ in forms:
                assert enc not in data and dec not in data \
                    and raw not in data, f"a deleted row survives in {p}"
            for k in gone:
                assert f'"{k}"'.encode() not in data, f"{k} survives in {p}"
        (snap,) = idx._store.snapshots()
        _, arrays = read_snapshot(str(d / snap))
        live_scales = set(idx._scales.tolist())
        stored = arrays["scales"][:idx.size]
        shared = 0
        for *_, scl in forms:
            hits = int((stored == np.float32(scl)).sum())
            if scl in live_scales:
                shared += 1
            else:
                assert hits == 0, "a deleted row's scale survives"
        assert np.array_equal(stored, idx._scales)
        live, _ = idx.query_batch(qs, k=10, ef=64)
        del idx
        release(torch)
        restored = make_index("hnsw", store=str(d), device="cuda")
        got, _ = restored.query_batch(qs, k=10, ef=64)
        assert got == live, "compacted store: restored keys differ"
        rec = dict(rows=n, dtype="int8", deleted=len(gone),
                   compact_s=compact_s, files=len(files),
                   disk_bytes=dir_bytes(d),
                   deleted_scales_shared_with_live_rows=shared,
                   restored_keys_equal_live=True)
        log(f"compact + secure delete on a {n:,}-row int8 prefix "
            + json.dumps(rec))
        del restored
        return rec
    finally:
        shutil.rmtree(d, ignore_errors=True)


def phase_serve_int8(torch) -> dict:
    """The HNSW served path over int8 rows at full width; then a bf16 HNSW
    of the same corpus, each on the card against the CPU."""
    from repro_torch.core import dispatch
    from repro_torch.core.index import make_index

    cfg, args, corpus, res, out = served_run(
        torch, ["--index", "hnsw", "--index-dtype", "int8"])
    log("serve hnsw int8 " + json.dumps(out))
    counts, es, rs = out["counters"], out["engine"], out["retrieval"]
    for c in HNSW_INT8_PATH:
        assert counts.get(c, 0) > 0, f"{c} never launched on the int8 path"
    assert counts["kernel.beam_search.int8"] == rs["searches"]
    assert counts["kernel.flash_decode"] == cfg.n_layers * es["decode_ticks"]
    rag, reqs = res["rag"], res["reqs"]
    got = [[d.key for d in r.docs] for r in reqs]
    qv = rag.encoder.encode([r.query for r in reqs])
    keys = [key for key, _ in corpus]
    vecs = rag.encoder.encode([text for _, text in corpus])
    conf = rag.index.config_dict()
    out["graph_max_level"] = rag.index.host_graph().max_level
    idx = {("int8", "cuda"): rag.index}
    del res, rag

    def hnsw_keys(dtype):
        idx[dtype, "cuda"] = make_index("hnsw", device="cuda",
                                        **dict(conf, dtype=dtype))
        idx[dtype, "cuda"].bulk_insert(keys, vecs)
        return idx[dtype, "cuda"].query_batch(qv, k=3)[0]

    def cpu_keys(dtype):
        """The card index's keys searched on a CPU copy: the same host
        graph and rows, a CPU device graph, the plain versions."""
        cpu = idx[dtype, "cpu"] = copy.copy(idx[dtype, "cuda"])
        cpu.device, cpu._devices = torch.device("cpu"), [torch.device("cpu")]
        cpu._device_graph = None
        return cpu.query_batch(qv, k=3)[0]

    want = cpu_keys("int8")
    assert got == want, f"served hnsw int8 keys {got} != CPU copy {want}"
    out["keys"] = {"int8 served": got}
    dispatch.reset()
    card = hnsw_keys("bf16")
    out["counters_bf16"] = dispatch.snapshot()
    cpu = cpu_keys("bf16")
    assert card == cpu, f"hnsw bf16: card {card} != CPU copy {cpu}"
    out["keys"]["bf16"] = card
    log("hnsw keys (int8 served == CPU copy; bf16 card == CPU copy) "
        + json.dumps(out["keys"]))
    # the hop kernel's route: these indexes (and an fp32 one) searched
    # with the per-hop layer-0 beam (beam_impl="jnp"), each hop one
    # gather_distance launch; its launches are the codec's gather
    # launches less the one descent a search
    hnsw_keys("fp32")
    cpu_keys("fp32")

    def per_hop_keys(dtype, device):
        c = copy.copy(idx[dtype, device])
        c.beam_impl = "jnp"
        return c.query_batch(qv, k=3)[0]

    out["per_hop_beam"] = {}
    for dtype in CODECS:
        dispatch.reset()
        card = per_hop_keys(dtype, "cuda")
        counts = dispatch.snapshot()
        cpu = per_hop_keys(dtype, "cpu")
        assert card == cpu, f"hnsw {dtype} per-hop beam: {card} != {cpu}"
        assert hop_launches(counts, dtype) > 0
        out["per_hop_beam"][dtype] = counts
    log("hnsw per-hop beam keys == CPU, counters "
        + json.dumps(out["per_hop_beam"]))
    return out


def phase_serve_store(torch) -> dict:
    """The int8 HNSW served path with a durable store, ``--store-dir``,
    once cold (embeds the corpus, snapshots on exit) and once warm
    (restores; inserts nothing, so the epoch, the WAL and the snapshots
    stay as they were, and retrieves the cold run's keys)."""
    d = store_dir("serve_store")
    try:
        argv = ["--index", "hnsw", "--index-dtype", "int8",
                "--store-dir", str(d)]
        runs = {}
        for name in ("cold", "warm"):
            cfg, _, _, res, rec = served_run(torch, argv)
            idx = res["rag"].index
            rec.update(
                keys=[[doc.key for doc in r.docs] for r in res["reqs"]],
                epoch=idx.mutation_epoch, size=idx.size,
                wal_bytes=(d / "wal.log").stat().st_size,
                snapshots=sorted(p.name for p in d.glob("snap_*")),
                disk_bytes=dir_bytes(d))
            counts = rec["counters"]
            for c in HNSW_INT8_PATH:
                assert counts.get(c, 0) > 0, f"{c} never launched ({name})"
            log(f"serve hnsw int8 --store-dir, {name} " + json.dumps(rec))
            runs[name] = rec
            del res, idx
            release(torch)
        cold, warm = runs["cold"], runs["warm"]
        assert cold["size"] > 0 and len(cold["snapshots"]) == 1
        for what in ("epoch", "size", "wal_bytes", "snapshots", "keys"):
            assert warm[what] == cold[what], \
                f"warm served run: {what} {warm[what]} != cold {cold[what]}"
        # the warm run's one graph upload is the restored graph's
        assert warm["counters"].get("hnsw.h2d_bytes", 0) > 0
        return {"cold": cold, "warm": warm, "model": cfg.name}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def cpu_copy(idx):
    """The same index (its ``state_dict``: rows, and IVF's centroids) on
    the CPU, where the kernels' plain versions run."""
    from repro_torch.core.index import make_index

    cpu = make_index(idx.kind, device="cpu", **idx.config_dict())
    cpu.restore_state(*idx.state_dict())
    return cpu


def phase_serve_ivf(torch) -> dict:
    """The IVF served path over int8 rows at full width, its keys held
    against the CPU on the same centroids; counted runs of fp32 and bf16
    IVF indexes of the corpus against the CPU; then the tiered served
    path, its keys and ``TierStats`` held against a CPU ``TieredIndex``
    of the same corpus."""
    from repro_torch.core import dispatch
    from repro_torch.core.index import make_index

    cfg, args, corpus, res, out = served_run(
        torch, ["--index", "ivf", "--index-dtype", "int8"])
    log("serve ivf int8 " + json.dumps(out))
    counts, es, rs = out["counters"], out["engine"], out["retrieval"]
    for c in IVF_INT8_PATH:
        assert counts.get(c, 0) > 0, f"{c} never launched on the ivf path"
    # every search: one coarse launch (fp32 centroids), one fine (int8)
    assert counts["kernel.gather_distance.fp32"] == rs["searches"] \
        == counts["kernel.gather_distance.int8"]
    assert counts["kernel.gather_distance"] == 2 * rs["searches"]
    assert counts["kernel.flash_decode"] == cfg.n_layers * es["decode_ticks"]
    rag, reqs = res["rag"], res["reqs"]
    got = [[d.key for d in r.docs] for r in reqs]
    qv = rag.encoder.encode([r.query for r in reqs])
    keys = [key for key, _ in corpus]
    vecs = rag.encoder.encode([text for _, text in corpus])
    conf = rag.index.config_dict()
    out["probe"] = rag.index.probe_plan()
    want = cpu_copy(rag.index).query_batch(qv, k=3)[0]
    assert got == want, f"served ivf int8 keys {got} != CPU {want}"
    out["keys"] = {"int8 served": got}
    del res, rag
    for dtype in ("fp32", "bf16"):
        # each codec's own counted run: trains, packs, searches once
        idx = make_index("ivf", device="cuda", **dict(conf, dtype=dtype))
        idx.bulk_insert(keys, vecs)
        dispatch.reset()
        card = idx.query_batch(qv, k=3)[0]
        counts = dispatch.snapshot()
        assert counts["kernel.gather_distance"] == 2
        assert counts[f"kernel.gather_distance.{dtype}"] >= 1
        cpu = cpu_copy(idx).query_batch(qv, k=3)[0]
        assert card == cpu, f"ivf {dtype}: card {card} != CPU {cpu}"
        out[f"counters_{dtype}"] = counts
        out["keys"][dtype] = card
    log("ivf keys (int8 served == CPU; fp32, bf16 card == CPU) "
        + json.dumps(out["keys"]))

    _, _, _, res, tier = served_run(torch, ["--index", "tiered"])
    log("serve tiered fp32 " + json.dumps(tier))
    counts, es = tier["counters"], tier["engine"]
    assert counts["kernel.flash_decode"] == cfg.n_layers * es["decode_ticks"]
    idx, reqs = res["rag"].index, res["reqs"]
    got = [[d.key for d in r.docs] for r in reqs]
    cpu = make_index("tiered", device="cpu", **idx.config_dict())
    cpu.bulk_insert(keys, vecs)
    assert got == cpu.query_batch(qv, k=3)[0], "served tiered keys != CPU"
    tier["served_stats"] = idx.stats.as_dict()
    # both from cold tiers: the same queries, the same slow-tier traffic
    idx._g = cpu._g = None
    card_k, card_d = idx.query_batch(qv, k=3)
    cpu_k, cpu_d = cpu.query_batch(qv, k=3)
    assert card_k == cpu_k and card_d.tobytes() == cpu_d.tobytes()
    assert idx.stats.as_dict() == cpu.stats.as_dict(), \
        f"tiered stats {idx.stats} != CPU {cpu.stats}"
    tier.update(keys=got, stats=idx.stats.as_dict())
    log("tiered keys and TierStats == CPU " + json.dumps(
        {"keys": got, "stats": tier["stats"]}))
    out["tiered"] = tier
    return out


def ivf_hop_cells(torch, idx, qs) -> dict:
    """The hop kernel at the 1M IVF index's two shapes, B 8: the coarse
    launch (K = nlist on the fp32 centroids) and the fine one (K =
    nprobe x cap on the int8 rows, ids clipped and pads masked after),
    each against its plain version (1e-5), its device time a launch, the
    call's and the plain version's time and the bound: the distinct rows
    read (+ scales), q, ids and the output once, over the HBM rate."""
    from repro_torch.kernels import ops, ref

    packed = idx._pack()
    nlist, cap = packed.lists.shape
    b = IVF_HOP_B
    q = torch.as_tensor(qs[:b], device="cuda")
    q = (q / torch.clamp_min(torch.linalg.vector_norm(
        q, dim=-1, keepdim=True), 1e-12)).contiguous()
    coarse = torch.arange(nlist, dtype=torch.int32,
                          device="cuda").expand(b, nlist).contiguous()
    cd = ops.gather_distance(packed.centroids, q, coarse)
    probe = ref.smallest_k(cd, coarse, idx.nprobe)[1]
    cand = packed.lists[probe.long()].reshape(b, idx.nprobe * cap)
    valid = cand >= 0
    fine = torch.clamp(cand, 0, packed.n - 1)
    cells = {}
    for name, rows, scales, ids in (
            ("coarse", packed.centroids, None, coarse),
            ("fine", packed.vectors, packed.scales, fine)):
        got = ops.gather_distance(rows, q, ids, scales=scales)
        want = ref.gather_distance_ref(rows, q, ids, scales=scales)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        assert err <= 1e-5, f"gather_distance ivf {name}: err {err}"
        distinct = torch.unique(ids if name == "coarse" else ids[valid])
        b_ms, b_by = bound(distinct.numel() * row_bytes(rows, scales)
                           + q.numel() * 4 + ids.numel() * 8,
                           (2.0 if scales is None else 3.0) * ids.numel()
                           * q.shape[1])
        call = lambda: ops.gather_distance(rows, q, ids, scales=scales)
        split = device_split(torch, call, "gather_distance_kernel", reps=64)
        assert split["other_device_ms"] == 0, f"ivf {name}: {split}"
        cells[name] = dict(
            max_abs_err=err, B=b, K=ids.shape[1], distinct_rows=
            distinct.numel(), valid_slots=int(valid.sum()) if name ==
            "fine" else ids.numel(), **split,
            queued_ms=queued_ms(torch, call, 64 if name == "coarse" else 16),
            ms=time_ms(torch, call, 20),
            plain_ms=time_ms(torch, lambda: ref.gather_distance_ref(
                rows, q, ids, scales=scales), 3, warmup=1),
            bound_ms=b_ms, bound_by=b_by,
            plan=ops._gather_plan(b, ids.shape[1], torch.cuda.
                                  get_device_properties(0).
                                  multi_processor_count),
            shapes=f"vectors {rows.shape[0]}x{rows.shape[1]} "
                   f"{ops.CODEC_OF[rows.dtype]}"
                   + ("" if scales is None else " + scales")
                   + f", q {b}x{q.shape[1]}, ids {b}x{ids.shape[1]}")
        log(f"gather_distance ivf {name} " + json.dumps(cells[name]))
    return cells


def ivf_store_round_trip(torch, idx, keys, qs, d: Path) -> dict:
    """The store on the 1M int8 IVF index (attached and snapshotted before
    its first search, which trained it and logged ``derived.centroids``):
    logged mutations, drop, warm restore; the restored index must answer
    the live one's keys with its epoch and centroids."""
    import numpy as np
    from repro_torch.core.index import make_index
    from repro_torch.store import IndexStore

    store = idx._store
    ops_logged = [h["op"] for h, _ in store.wal.records()]
    assert ops_logged == ["derived.centroids"], ops_logged
    rng = np.random.default_rng(19)
    fresh = rng.normal(size=(IVF_INSERTS + IVF_UPDATES,
                             qs.shape[1])).astype(np.float32)
    t0 = time.perf_counter()
    idx.bulk_insert([f"new{j}" for j in range(IVF_INSERTS)],
                    fresh[:IVF_INSERTS])
    picks = rng.choice(len(keys), IVF_UPDATES + IVF_DELETES, replace=False)
    for j, r in enumerate(picks[:IVF_UPDATES]):
        idx.update(keys[int(r)], fresh[IVF_INSERTS + j])
    for r in picks[IVF_UPDATES:]:
        idx.delete(keys[int(r)])
    mutate_s = time.perf_counter() - t0
    live = dict(keys=idx.query_batch(qs[:IVF_SAMPLE], k=10)[0],
                epoch=idx.mutation_epoch, size=idx.size,
                centroids=idx._centroids.tobytes())
    wal_bytes = store.wal.size_bytes
    t0 = time.perf_counter()
    restored = make_index("ivf", store=IndexStore(str(d)), device="cuda")
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = restored.query_batch(qs[:IVF_SAMPLE], k=10)[0]
    first_query_s = time.perf_counter() - t0
    assert restored.mutation_epoch == live["epoch"]
    assert restored.size == live["size"]
    assert restored._centroids.tobytes() == live["centroids"]
    assert got == live["keys"], "restored ivf: keys differ from the live"
    return dict(inserts=IVF_INSERTS, updates=IVF_UPDATES,
                deletes=IVF_DELETES, mutate_s=mutate_s, wal_bytes=wal_bytes,
                restore_s=restore_s, first_query_s=first_query_s,
                epoch=live["epoch"], keys_equal_live=True,
                centroids_equal_live=True, disk_bytes=dir_bytes(d))


def phase_ivf_1m(torch) -> dict:
    """IVF at the paper's scale: ``build_1m``'s 1M x 384 seeded cosine
    rows in an int8 ``IVFVectorIndex`` (nlist, nprobe from
    RetrievalConfig), attached to a store and snapshotted; k-means twice on
    the card (bit for bit, timed); the first search's pack (it trains
    again, equal to both, and logs ``derived.centroids``); the hop
    kernel's coarse and fine cells (device time a launch from the profiler
    and queued behind a spin kernel); ``query_batch`` at B 8 and 128; a
    16-query sample against the CPU; ``exact_query`` against a
    ``FlatVectorIndex`` of the same int8 rows; the store round trip."""
    import numpy as np
    from repro_torch.configs.mememo import CONFIG
    from repro_torch.core import dispatch
    from repro_torch.core import ivf as tivf
    from repro_torch.core.codec import device_rows
    from repro_torch.core.flat import FlatVectorIndex
    from repro_torch.core.index import make_index
    from repro_torch.store import IndexStore

    cfg = CONFIG.model
    gen = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randn(BULK_ROWS, cfg.dim, device="cuda",
                    generator=gen).cpu().numpy()
    qs = torch.randn(max(IVF_BATCHES), cfg.dim, device="cuda",
                     generator=gen).cpu().numpy()
    keys = [f"v{i}" for i in range(BULK_ROWS)]
    idx = make_index("ivf", dim=cfg.dim, metric=cfg.metric, nlist=cfg.nlist,
                     nprobe=cfg.nprobe, dtype="int8", device="cuda")
    t0 = time.perf_counter()
    idx.bulk_insert(keys, x)
    ingest_s = time.perf_counter() - t0
    d = store_dir("ivf_store")
    try:
        store = IndexStore(str(d))
        store.attach(idx)
        t0 = time.perf_counter()
        store.snapshot(idx)
        snapshot_s = time.perf_counter() - t0
        # k-means twice over the index's rows: the same centroids, bit for
        # bit (the per-cluster sums are a product, not atomics)
        rows = device_rows(idx._rows.vectors, "cuda")
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c, a = tivf.kmeans(rows, cfg.nlist, idx.iters, idx.seed)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0, c.cpu().numpy(),
                         a.cpu().numpy()))
        del rows, c, a
        assert runs[0][1].tobytes() == runs[1][1].tobytes(), \
            "k-means on the card: two runs trained different centroids"
        assert np.array_equal(runs[0][2], runs[1][2])
        t0 = time.perf_counter()
        idx._pack()                    # trains again, logs, builds, uploads
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        assert idx._centroids.tobytes() == runs[0][1].tobytes()
        plan = idx.probe_plan()
        out = dict(rows=BULK_ROWS, dim=cfg.dim, dtype="int8", **plan,
                   iters=idx.iters, ingest_s=ingest_s,
                   snapshot_s=snapshot_s,
                   kmeans_s=[r[0] for r in runs], pack_s=pack_s,
                   list_sizes=np.bincount(runs[0][2],
                                          minlength=cfg.nlist).tolist(),
                   kmeans_deterministic=True)
        log("ivf 1M int8 " + json.dumps(out))
        out["hop"] = ivf_hop_cells(torch, idx, qs)
        out["query_batch"] = {}
        for b in IVF_BATCHES:
            idx.query_batch(qs[:b], k=10)
            torch.cuda.synchronize()
            dispatch.reset()
            t0 = time.perf_counter()
            for _ in range(3):
                idx.query_batch(qs[:b], k=10)
            torch.cuda.synchronize()
            out["query_batch"][f"B{b}"] = dict(
                wall_ms=(time.perf_counter() - t0) * 1e3 / 3,
                counters=dispatch.snapshot())
        log("ivf 1M query_batch k 10 " + json.dumps(out["query_batch"]))
        # the sample against the plain versions on the CPU, 4 queries a
        # call (a call gathers [4, K, 384] floats)
        got = idx.query_batch(qs[:IVF_SAMPLE], k=10)[0]
        cpu = cpu_copy(idx)
        want = []
        for i in range(0, IVF_SAMPLE, 4):
            want += cpu.query_batch(qs[i:i + 4], k=10)[0]
        del cpu
        assert got == want, "ivf 1M: card keys differ from the CPU's"
        # nprobe = nlist is exact: the flat index of the same int8 rows
        arrays, meta = idx.state_dict()
        flat = FlatVectorIndex(metric=cfg.metric, dim=cfg.dim, dtype="int8",
                               device="cuda")
        flat.restore_state({k: v for k, v in arrays.items()
                            if k != "centroids"}, meta)
        exact = idx.exact_query(qs[:IVF_SAMPLE], k=10)[0]
        assert exact == flat.query_batch(qs[:IVF_SAMPLE], k=10)[0], \
            "ivf 1M exact_query != flat int8"
        recall = sum(len(set(g) & set(e)) for g, e in zip(got, exact)) / (
            10 * IVF_SAMPLE)
        del flat, arrays, meta
        out.update(sample=IVF_SAMPLE, keys_equal_cpu=True,
                   exact_equals_flat=True, recall_at_10_vs_exact=recall)
        out["store"] = ivf_store_round_trip(torch, idx, keys, qs, d)
        log("ivf 1M sample == CPU, exact_query == flat int8 (recall@10 "
            f"{recall:.4f}); store " + json.dumps(out["store"]))
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 9: the sharded index
# ---------------------------------------------------------------------------
def shard_env(devices: str | None):
    """Set (a comma list) or clear ``REPRO_TORCH_SHARD_DEVICES`` -> the
    value it had, for ``shard_env`` to put back."""
    from repro_torch.core.sharded import SHARD_DEVICES_ENV
    old = os.environ.get(SHARD_DEVICES_ENV)
    if devices is None:
        os.environ.pop(SHARD_DEVICES_ENV, None)
    else:
        os.environ[SHARD_DEVICES_ENV] = devices
    return old


def walls_ms(torch, idx, qs, reps: int = 10) -> dict:
    """``query_batch`` wall (ms, host clock; the call ends in a read of
    its merged result) at each of ``SHARD_BATCHES``: the median of
    ``reps`` calls timed one by one, after two warm calls."""
    out = {}
    for b in SHARD_BATCHES:
        for _ in range(2):
            idx.query_batch(qs[:b], k=10)
        torch.cuda.synchronize()
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            idx.query_batch(qs[:b], k=10)
            ms.append((time.perf_counter() - t0) * 1e3)
        out[f"B{b}"] = statistics.median(ms)
    return out


def counted(torch, fn) -> dict:
    """The counters of one call of ``fn``, zeroed just before."""
    from repro_torch.core import dispatch
    dispatch.reset()
    fn()
    torch.cuda.synchronize()
    return dispatch.snapshot()


def shard_topk_agree(torch, placed, q, k: int) -> list[dict]:
    """Each shard's ``distance_topk`` call as the flat fan-out makes it
    (its block, k + slack_s rows) against the plain version on the same
    inputs, every column (``assert_topk_agree``: distances within 1e-5,
    ids equal wherever the distances are not tied to 1e-6)."""
    from repro_torch.kernels import ops, ref

    out = []
    scales = placed.scales or [None] * len(placed.blocks)
    for s, (blk, scl) in enumerate(zip(placed.blocks, scales)):
        kk = min(k + placed.slack[s], blk.shape[0])
        qd = q.to(blk.device)
        got = ops.flat_topk(blk, qd, kk, scales=scl)
        want = ref.distance_topk_ref(blk, qd, kk, scales=scl)
        frac = assert_topk_agree(torch, got, want,
                                 f"shard {s} distance_topk k {kk}")
        out.append(dict(shard=s, rows=blk.shape[0], k=kk,
                        passes=-(-kk // ops.TOPK_PASS_K),
                        max_abs_err=(got[0] - want[0]).abs().max().item(),
                        ids_equal_frac=frac))
    return out


def shard_topk_cells(torch, placed, q, k: int) -> list[dict]:
    """Each shard's ``distance_topk`` launch as the flat fan-out makes it
    (its block, k + slack_s rows), held against the plain version
    (``shard_topk_agree``), device ms a launch (profiler) and a call
    (CUDA events), with the bound of its rows; the plain version's time
    on shard 0."""
    from repro_torch.kernels import ops, ref

    cells = shard_topk_agree(torch, placed, q, k)
    scales = placed.scales or [None] * len(placed.blocks)
    for cell, blk, scl in zip(cells, placed.blocks, scales):
        kk = cell["k"]
        qd = q.to(blk.device)
        call = lambda: ops.flat_topk(blk, qd, kk, scales=scl)
        b_ms, b_by = topk_bound(blk, scl, q.shape[0], kk)
        with torch.cuda.device(blk.device):   # events on the shard's card
            split = device_split(torch, call, "distance_topk", reps=8)
            ms = time_ms(torch, call, 10)
        cell.update(**split, ms=ms, bound_ms=b_ms, bound_by=b_by,
                    device=str(blk.device))
    blk0, q0, kk0 = placed.blocks[0], q.to(placed.blocks[0].device), \
        cells[0]["k"]
    cells[0]["plain_ms"] = time_ms(torch, lambda: ref.distance_topk_ref(
        blk0, q0, kk0, scales=scales[0]), 3, warmup=1)
    cells[0]["library_ms"] = library_topk_ms(torch, blk0, scales[0], q0, kk0)
    return cells


def library_topk_ms(torch, db, scales, q, k: int, metric: str = "cosine"
                    ) -> float:
    """The library call of ``distance_topk``'s rows: ``torch.mm`` (TF32
    off) and ``torch.topk`` on the decoded fp32 rows, CUDA events a
    call (the decode is done once, outside the timed call)."""
    xf = db.float() if scales is None else db.float() * scales[:, None]
    if metric == "l2":
        xx = (xf * xf).sum(dim=1)
        fn = lambda: torch.topk((q * q).sum(dim=1, keepdim=True)
                                - 2.0 * torch.mm(q, xf.T) + xx, k, dim=1,
                                largest=False)
    else:
        fn = lambda: torch.topk(1.0 - torch.mm(q, xf.T), k, dim=1,
                                largest=False)
    assert not torch.backends.cuda.matmul.allow_tf32
    return time_ms(torch, fn, 10)


def shard_hop_cells(torch, sp, q, nprobe: int) -> list[dict]:
    """Each shard's fine hop launch of the IVF fan-out (K = nprobe x its
    cap), ids clipped as the search clips them, against its plain version
    (1e-5 where valid); device ms a launch and a call, and the bound of
    the distinct valid rows it reads."""
    from repro_torch.kernels import ops, ref

    b = q.shape[0]
    cells = []
    scales = sp.placed.scales or [None] * len(sp.lists)
    for s, (blk, scl, lists) in enumerate(zip(sp.placed.blocks, scales,
                                              sp.lists)):
        q = q.to(blk.device)
        coarse = torch.arange(sp.nlist, dtype=torch.int32, device=q.device
                              ).expand(b, sp.nlist).contiguous()
        cd = ops.gather_distance(sp.centroids[q.device], q, coarse)
        probe = ref.smallest_k(cd, coarse, nprobe)[1].reshape(-1).long()
        cand = lists[probe].reshape(b, nprobe * lists.shape[1])
        valid = cand >= 0
        ids = torch.clamp(cand, 0, blk.shape[0] - 1)
        got = ops.gather_distance(blk, q, ids, scales=scl)
        want = ref.gather_distance_ref(blk, q, ids, scales=scl)
        err = (got - want)[valid].abs().max().item()
        assert err <= 1e-5, f"shard {s} fine hop: err {err}"
        distinct = torch.unique(ids[valid]).numel()
        b_ms, b_by = bound(distinct * row_bytes(blk, scl) + q.numel() * 4
                           + ids.numel() * 8, 3.0 * ids.numel() * q.shape[1])
        call = lambda: ops.gather_distance(blk, q, ids, scales=scl)
        with torch.cuda.device(blk.device):   # events on the shard's card
            split = device_split(torch, call, "gather_distance_kernel",
                                 reps=16)
            ms = time_ms(torch, call, 10)
        if s == 0:
            plain_ms = time_ms(torch, lambda: ref.gather_distance_ref(
                blk, q, ids, scales=scl), 5, warmup=1)
        cells.append(dict(shard=s, K=ids.shape[1], cap=lists.shape[1],
                          valid_slots=int(valid.sum()), distinct_rows=
                          distinct, max_abs_err=err, **split, ms=ms,
                          **({"plain_ms": plain_ms} if s == 0 else {}),
                          bound_ms=b_ms, bound_by=b_by,
                          device=str(blk.device)))
    return cells


def shard_merge_ms(torch, placed, q, k: int) -> dict:
    """The tree merge of the flat fan-out's four [B, k] lists (CUDA
    events a call; the lists built as the fan-out builds them)."""
    from repro_torch.core.sharded import trim_merge_width
    from repro_torch.distributed.collectives import hierarchical_topk
    from repro_torch.kernels import ops

    parts = []
    scales = placed.scales or [None] * len(placed.blocks)
    for blk, gid, scl, sl in zip(placed.blocks, placed.gids, scales,
                                 placed.slack):
        d, i = ops.flat_topk(blk, q.to(blk.device),
                             min(k + sl, blk.shape[0]), scales=scl)
        g = gid[i.long()]
        parts.append(trim_merge_width(torch.where(g >= 0, d, 3e38), g, k))
    merge = lambda: hierarchical_topk(parts, k, tie_break_ids=True)
    oracle = hierarchical_topk(parts, k, tie_break_ids=True, tree=False)
    got = merge()
    assert torch.equal(got[1], oracle[1]) and torch.equal(got[0], oracle[0])
    return dict(B=q.shape[0], k=k, shards=len(parts),
                ms=time_ms(torch, merge, 20), equals_oracle=True)


def sharded_1m(torch, x, qs, keys, shards: int) -> dict:
    """Flat and IVF int8 over ``build_1m``'s rows at ``shards`` shards
    against the 1-shard indexes of the same rows: keys on a sample, the
    wall of a search at B 8 and 128, each shard's launches; the 4-shard
    indexes come from the 1-shard state (the canonical arrays), IVF's on
    the 1-shard index's centroids."""
    import numpy as np
    from repro_torch.configs.mememo import CONFIG
    from repro_torch.core.index import make_index
    from repro_torch.kernels import ops

    cfg = CONFIG.model
    common = dict(dim=cfg.dim, metric=cfg.metric, dtype="int8",
                  device="cuda")
    t0 = time.perf_counter()
    flat1 = make_index("flat", **common)
    flat1.bulk_insert(keys, x)
    ingest_s = time.perf_counter() - t0
    arrays, meta = flat1.state_dict()
    ivf_cfg = dict(common, nlist=cfg.nlist, nprobe=cfg.nprobe)
    t0 = time.perf_counter()
    flat4 = make_index("flat", n_shards=shards, **common)
    flat4.restore_state(arrays, meta)
    ivf1 = make_index("ivf", **ivf_cfg)
    ivf1.restore_state(dict(arrays, centroids=np.zeros((0, cfg.dim),
                                                       np.float32)),
                       dict(meta, has_centroids=False))
    ivf1.query_batch(qs[:1], k=10)                   # trains
    # both on the trained centroids, the rows assigned on the host alike
    ivf1._invalidate()
    ivf4 = make_index("ivf", n_shards=shards, **ivf_cfg)
    ivf4.restore_state(*ivf1.state_dict())
    adopt_s = time.perf_counter() - t0
    out = dict(rows=len(keys), shards=shards, ingest_s=ingest_s,
               adopt_s=adopt_s, arrays=arrays)
    for name, one, four in (("flat", flat1, flat4), ("ivf", ivf1, ivf4)):
        t0 = time.perf_counter()
        got = four.query_batch(qs[:SHARD_SAMPLE], k=10)[0]
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0           # packs the shards
        assert got == one.query_batch(qs[:SHARD_SAMPLE], k=10)[0], \
            f"{name} at {shards} shards: keys differ from one shard"
        counts = counted(torch, lambda: four.query_batch(qs[:8], k=10))
        if name == "flat":
            # a shard's launch fetches k + slack_s rows: passes of 256
            placed = four._rows.pack()
            passes = sum(-(-min(10 + sl, b.shape[0]) // ops.TOPK_PASS_K)
                         for b, sl in zip(placed.blocks, placed.slack))
            assert counts["kernel.distance_topk.int8"] == passes, counts
        else:
            distinct = len(set(four._rows.devices))
            assert counts["kernel.gather_distance.fp32"] == distinct
            assert counts["kernel.gather_distance.int8"] == shards, counts
        out[name] = dict(keys_equal_one_shard=True, first_search_s=first_s,
                         wall_ms={"1 shard": walls_ms(torch, one, qs),
                                  f"{shards} shards": walls_ms(torch, four,
                                                               qs)},
                         shard_stats=four.shard_stats(), counters=counts,
                         device_block_bytes=four._rows.device_block_bytes())
    q8 = torch.as_tensor(qs[:8], device="cuda")
    q8 = (q8 / torch.clamp_min(torch.linalg.vector_norm(
        q8, dim=-1, keepdim=True), 1e-12)).contiguous()
    placed = flat4._rows.pack()
    out["flat"]["slack"] = placed.slack
    out["flat"]["shard_topk"] = shard_topk_cells(torch, placed, q8, 10)
    out["flat"]["merge"] = shard_merge_ms(torch, placed, q8, 10)
    out["ivf"]["probe"] = ivf4.probe_plan()
    out["ivf"]["shard_hop"] = shard_hop_cells(torch, ivf4._pack_sharded(),
                                              q8, cfg.nprobe)
    out["flat"]["churned"] = churned_flat(torch, flat1, flat4, qs, keys, q8)
    return out


def churned_flat(torch, one, four, qs, keys, q8) -> dict:
    """Deletes below the relayout fraction leave free slots in each
    shard's block, so the fan-out over-fetches k + slack_s rows in
    several ``distance_topk`` passes: keys against one shard with the
    same deletes, and each shard's multi-pass call against the plain
    version, every column."""
    from repro_torch.core.sharded import REPACK_FREE_FRACTION

    gone = keys[::SHARD_CHURN_EVERY]
    for idx in (one, four):
        for key in gone:
            idx.delete(key)
    got = four.query_batch(qs[:SHARD_SAMPLE], k=10)[0]
    assert got == one.query_batch(qs[:SHARD_SAMPLE], k=10)[0], \
        "churned flat: keys differ from one shard"
    stats = four.shard_stats()
    assert sum(x["free"] for x in stats) / sum(x["slots"] for x in stats) \
        <= REPACK_FREE_FRACTION, stats
    placed = four._rows.pack()
    cells = shard_topk_agree(torch, placed, q8, 10)
    assert all(c["passes"] > 1 for c in cells), cells
    return dict(deleted=len(gone), slack=placed.slack,
                keys_equal_one_shard=True, shard_topk=cells)


def sharded_store(torch, x, keys, arrays, shards: int) -> dict:
    """The first ``SHARD_STORE_ROWS`` rows (of the int8 flat index's
    canonical ``arrays``) in an int8 flat store written at ``shards``
    shards (snapshot + logged mutations) restored at 1, and one written at
    1 restored at ``shards``: keys, epoch and ``state_dict`` equal the
    writer's."""
    import numpy as np
    from repro_torch.core.index import make_index
    from repro_torch.store import IndexStore

    n = SHARD_STORE_ROWS
    qs = x[:SHARD_SAMPLE] + 0.01
    out = {}
    for src, dst in ((shards, 1), (1, shards)):
        d = store_dir(f"shard_store_{src}")
        try:
            idx = make_index("flat", store=IndexStore(str(d)), dim=x.shape[1],
                             dtype="int8", n_shards=src, device="cuda")
            # the prefix's canonical arrays, with no second ingest
            idx.restore_state({"vectors_enc": arrays["vectors_enc"][:n],
                               "scales": arrays["scales"][:n],
                               "alive": arrays["alive"][:n]},
                              {"keys": keys[:n], "epoch": 1})
            idx._store.snapshot(idx)
            idx.insert("late", x[n])
            idx.delete(keys[3])
            want = idx.query_batch(qs, k=10)[0]
            t0 = time.perf_counter()
            back = make_index("flat", store=IndexStore(str(d)),
                              n_shards=dst, device="cuda")
            got = back.query_batch(qs, k=10)[0]
            restore_s = time.perf_counter() - t0
            assert back.shard_count == dst and got == want
            assert back.mutation_epoch == idx.mutation_epoch
            (a1, m1), (a2, m2) = idx.state_dict(), back.state_dict()
            assert m1 == m2 and all(np.array_equal(a1[k], a2[k]) for k in a1)
            out[f"{src}->{dst}"] = dict(rows=n, restore_s=restore_s,
                                        epoch=back.mutation_epoch,
                                        keys_equal=True, state_equal=True,
                                        disk_bytes=dir_bytes(d))
        finally:
            shutil.rmtree(d, ignore_errors=True)
    return out


def child_agree(torch, idx, qs) -> dict:
    """Every child graph's descent and beam, as the sharded search
    launches them at B 8 and 128, against their plain versions on the
    same inputs: the descent bit for bit against the per-hop loop through
    the hop kernel and, with the beam, against the plain version
    (``beam_agree``'s bars: ids equal on >= 99 % of the queries, here
    pooled over the children; distances within 1e-5 where equal)."""
    from repro_torch.core import hnsw as thnsw
    from repro_torch.kernels import ops, ref

    got, want, moved, err = [], [], 0, 0.0
    ep_same = ep_n = 0
    for child in idx._shards:
        if child._builder is None:
            continue
        dg = child._dg()
        for b in SHARD_BATCHES:
            q = thnsw._prep_queries(dg, qs[:b])
            # the entry point and its distance as ``hnsw.search_core``
            # makes them
            ep = torch.full((b,), dg.entry, dtype=torch.int32,
                            device=q.device)
            x0 = dg.vectors[ep.long()].float()
            if dg.scales is not None:
                x0 = x0 * dg.scales[ep.long()][:, None]
            ep_d = thnsw.batched_dist(dg.metric, q, x0[:, None])[:, 0]
            ep_d = ep_d.contiguous()
            dkw = dict(max_level=dg.max_level, metric=dg.metric,
                       scales=dg.scales)
            ge, gd = ops.greedy_descent(dg.vectors, dg.upper, q, ep, ep_d,
                                        **dkw)
            le, ld = ref.greedy_descent_ref(dg.vectors, dg.upper, q, ep,
                                            ep_d, gather=ops.gather_distance,
                                            **dkw)
            we, wd = ref.greedy_descent_ref(dg.vectors, dg.upper, q, ep,
                                            ep_d, **dkw)
            assert torch.equal(ge, le) and torch.equal(gd, ld), \
                "child descent differs from the per-hop loop"
            same = ge == we
            ep_same += int(same.sum())
            ep_n += b
            if bool(same.any()):
                err = max(err, (gd[same] - wd[same]).abs().max().item())
            moved += int((ge != ep).sum())
            kw = dict(ef=max(idx.ef_search, 10), metric=dg.metric,
                      scales=dg.scales, expand_t=thnsw.DEFAULT_EXPAND_T)
            got.append(ops.beam_search(dg.vectors, dg.neighbors0, q, ge, gd,
                                       **kw))
            want.append(ref.beam_search_ref(dg.vectors, dg.neighbors0, q, ge,
                                            gd, **kw))
    assert ep_same >= 0.99 * ep_n, f"child descent: ep equal {ep_same}/{ep_n}"
    assert err <= 1e-5, f"child descent: ep_dist err {err}"
    ki, kd = (torch.cat(x) for x in zip(*got))
    ri, rd = (torch.cat(x) for x in zip(*want))
    rec = beam_agree(torch, ki, kd, ri, rd, "child beam_search")
    return dict(descent_equals_per_hop_loop=True,
                descent_ep_equal_plain_frac=ep_same / ep_n,
                descent_max_abs_err=err, descent_queries_moved=moved,
                beam=rec, queries=ep_n)


def shard_child_cells(torch, idx, qs) -> dict:
    """The descent and the beam of one child graph (shard 0) of the
    sharded HNSW, as its search launches them at B 8: device ms a launch
    and a call, the plain versions' ms, and each bound from the plain
    version's traversal (the descent's as ``check_descent`` counts it);
    every child held against the plain versions first (``child_agree``)."""
    from repro_torch.core import hnsw as thnsw
    from repro_torch.kernels import ops, ref

    agree = child_agree(torch, idx, qs)

    dg = idx._shards[0]._dg()
    q = thnsw._prep_queries(dg, qs[:8])
    ep = torch.full((8,), dg.entry, dtype=torch.int32, device=q.device)
    ep_d = ref.gather_distance_ref(dg.vectors, q, ep[:, None],
                                   scales=dg.scales)[:, 0].contiguous()
    desc = lambda: ops.greedy_descent(dg.vectors, dg.upper, q, ep, ep_d,
                                      max_level=dg.max_level,
                                      scales=dg.scales)
    ep2, ep2_d = desc()
    kw = dict(ef=idx.ef_search, scales=dg.scales)
    beam = lambda: ops.beam_search(dg.vectors, dg.neighbors0, q, ep2, ep2_d,
                                   **kw)
    seen = [ref.beam_search_ref(dg.vectors, dg.neighbors0, q, ep2, ep2_d,
                                return_visited=True, **kw)[2]]
    out = {"rows": idx._shards[0]._builder.n, "capacity": dg.n,
           "max_level": dg.max_level, "agree": agree}
    if dg.max_level > 0:
        m = dg.upper.shape[2]
        first = {}
        ref.greedy_descent_ref(dg.vectors, dg.upper, q, ep, ep_d,
                               max_level=dg.max_level, scales=dg.scales,
                               stats=first)
        nbytes = (first["lists"] * m * 4 + int(first["rows"].sum().item())
                  * row_bytes(dg.vectors, dg.scales) + 8 * (q.shape[1] * 4
                                                            + 16))
        per_elem = 2.0 if dg.scales is None else 3.0
        b_ms, b_by = bound(nbytes, per_elem * first["pairs"] * q.shape[1])
        split = device_split(torch, desc, "greedy_descent_kernel", reps=16)
        out["descent"] = dict(
            **split, ms=time_ms(torch, desc, 20), B=8, M=m,
            plain_ms=time_ms(torch, lambda: ref.greedy_descent_ref(
                dg.vectors, dg.upper, q, ep, ep_d, max_level=dg.max_level,
                scales=dg.scales), 5, warmup=1),
            bound_ms=b_ms, bound_by=b_by,
            hops_max=int(first["hops"].max().item()))
    split = device_split(torch, beam, "beam_search", reps=16)
    out["beam"] = dict(**split, ms=time_ms(torch, beam, 20), B=8,
                       plain_ms=time_ms(torch, lambda: ref.beam_search_ref(
                           dg.vectors, dg.neighbors0, q, ep2, ep2_d, **kw),
                           5, warmup=1),
                       ef=kw["ef"], m2=dg.neighbors0.shape[1],
                       **beam_work(dg.vectors, dg.scales,
                                   dg.neighbors0.shape[1], 8, kw["ef"],
                                   seen))
    return out


def sharded_hnsw(torch, shards: int) -> dict:
    """HNSW over ``SHARD_HNSW_ROWS`` x 384 rows at ``shards`` shards (the
    paper's M 5, efConstruction 20; each child built by the host
    builder, as the reference builds them): keys on a sample equal the
    loop oracle's (each child searched on its own, a host merge),
    ``exact_query`` equal a 1-shard index of the same rows (device bulk
    build), the wall of a search at B 8 and 128 against it, and one
    child's descent and beam launches."""
    import numpy as np
    from repro_torch.configs.mememo import CONFIG
    from repro_torch.core.index import make_index

    cfg = CONFIG.model
    rng = np.random.default_rng(23)
    x = rng.standard_normal((SHARD_HNSW_ROWS, cfg.dim)).astype(np.float32)
    qs = rng.standard_normal((max(SHARD_BATCHES), cfg.dim)).astype(
        np.float32)
    keys = [f"h{i}" for i in range(SHARD_HNSW_ROWS)]
    common = dict(metric=cfg.metric, M=cfg.M,
                  ef_construction=cfg.ef_construction,
                  ef_search=cfg.ef_search, device="cuda")
    idx = make_index("hnsw", n_shards=shards, **common)
    t0 = time.perf_counter()
    idx.bulk_insert(keys, x)
    build_s = time.perf_counter() - t0
    one = make_index("hnsw", use_bulk_build=True, **common)
    t0 = time.perf_counter()
    one.bulk_insert(keys, x)
    one_build_s = time.perf_counter() - t0
    got = idx.query_batch(qs[:SHARD_SAMPLE], k=10)[0]
    loop = idx._query_batch_sharded_loop(qs[:SHARD_SAMPLE], 10, None)[0]
    assert got == loop, "sharded hnsw: keys differ from the loop oracle"
    assert idx.exact_query(qs[:SHARD_SAMPLE], k=10)[0] == \
        one.exact_query(qs[:SHARD_SAMPLE], k=10)[0]
    counts = counted(torch, lambda: idx.query_batch(qs[:8], k=10))
    assert counts["kernel.beam_search.fp32"] == shards, counts
    deep = sum(c._builder.max_level > 0 for c in idx._shards)
    assert counts.get("hnsw.descent_launches.fp32", 0) == deep, counts
    return dict(rows=SHARD_HNSW_ROWS, shards=shards, M=cfg.M,
                ef_construction=cfg.ef_construction,
                host_build_s=build_s, one_shard_bulk_build_s=one_build_s,
                shard_stats=idx.shard_stats(), keys_equal_loop=True,
                exact_equal_one_shard=True, counters=counts,
                wall_ms={"1 shard": walls_ms(torch, one, qs),
                         f"{shards} shards": walls_ms(torch, idx, qs)},
                child=shard_child_cells(torch, idx, qs))


def phase_sharded(torch) -> dict:
    """The sharded index (``n_shards`` 4). On a one-card machine the four
    shards share cuda:0 (``REPRO_TORCH_SHARD_DEVICES``), so their launches
    run one after another; with two or more cards the 1M cells run again
    with one shard a card. (a) flat and IVF int8 over ``build_1m``'s rows
    at 4 shards against 1 shard; (b) HNSW over 2,500 x 384 rows at 4
    shards against the loop oracle; (c) int8 flat stores written at 4
    shards restored at 1 and back; (d) the served path ``--rag --shards 4
    --index hnsw --index-dtype int8``, its keys against a CPU copy."""
    from repro_torch.configs.mememo import CONFIG

    cfg = CONFIG.model
    old = shard_env(",".join(["cuda:0"] * SHARDS))
    try:
        gen = torch.Generator(device="cuda").manual_seed(29)
        x = torch.randn(BULK_ROWS, cfg.dim, device="cuda",
                        generator=gen).cpu().numpy()
        qs = torch.randn(max(SHARD_BATCHES), cfg.dim, device="cuda",
                         generator=gen).cpu().numpy()
        keys = [f"v{i}" for i in range(BULK_ROWS)]
        out = {"one_card": sharded_1m(torch, x, qs, keys, SHARDS)}
        arrays = out["one_card"].pop("arrays")
        log("sharded 1M int8, 4 shards on cuda:0 " + json.dumps(
            out["one_card"]))
        release(torch)
        n_dev = torch.cuda.device_count()
        if n_dev >= 2:
            shard_env(None)
            out["distinct_cards"] = sharded_1m(torch, x, qs, keys,
                                               min(SHARDS, n_dev))
            out["distinct_cards"].pop("arrays")
            log("sharded 1M int8, one shard a card " + json.dumps(
                out["distinct_cards"]))
            shard_env(",".join(["cuda:0"] * SHARDS))
            release(torch)
        else:
            out["distinct_cards"] = None
            log(f"{n_dev} card: the one-shard-a-card cells did not run")
        out["store"] = sharded_store(torch, x, keys, arrays, SHARDS)
        log("sharded store round trips " + json.dumps(out["store"]))
        del x, arrays
        out["hnsw"] = sharded_hnsw(torch, SHARDS)
        log("sharded hnsw " + json.dumps(out["hnsw"]))
        release(torch)
        cfg_lm, _, _, res, rec = served_run(
            torch, ["--index", "hnsw", "--index-dtype", "int8", "--shards",
                    str(SHARDS)])
        log(f"serve hnsw int8 --shards {SHARDS} " + json.dumps(rec))
        counts, es, rs = rec["counters"], rec["engine"], rec["retrieval"]
        for c in HNSW_INT8_PATH:
            assert counts.get(c, 0) > 0, f"{c} never launched, 4 shards"
        assert counts["kernel.beam_search.int8"] == SHARDS * rs["searches"]
        assert counts["kernel.flash_decode"] == \
            cfg_lm.n_layers * es["decode_ticks"]
        rag, reqs = res["rag"], res["reqs"]
        assert rag.index.shard_count == SHARDS
        got = [[d.key for d in r.docs] for r in reqs]
        qv = rag.encoder.encode([r.query for r in reqs])
        want = cpu_copy(rag.index).query_batch(qv, k=3)[0]
        assert got == want, f"served 4-shard keys {got} != CPU {want}"
        rec.update(keys=got, keys_equal_cpu=True,
                   shard_stats=rag.index.shard_stats())
        out["served"] = rec
        return out
    finally:
        shard_env(old)


# ---------------------------------------------------------------------------
# phase 10: the multi-tenant pool
# ---------------------------------------------------------------------------
def pool_rows(torch, n_tenants: int, rows: int, seed: int):
    """Seeded cosine rows for ``n_tenants`` tenants of ``rows`` rows
    (tenant j holds rows [j * rows, (j + 1) * rows)) and 128 queries."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n_tenants * rows, DIM, device="cuda", generator=gen)
    qs = torch.randn(POOL_MULTI_B, DIM, device="cuda", generator=gen)
    return x.cpu().numpy(), qs.cpu().numpy()


def fill_pool(torch, pool, x, n_tenants: int, rows: int,
              prefix: str = "u") -> float:
    """Tenant by tenant ``bulk_insert`` of ``rows`` keys each (the same
    key names in every tenant's namespace) -> the fill's wall seconds,
    the first pack of the arena included."""
    keys = [f"d{i}" for i in range(rows)]
    t0 = time.perf_counter()
    for j in range(n_tenants):
        pool.bulk_insert(f"{prefix}{j}", keys, x[j * rows:(j + 1) * rows])
    pool._arena.pack_arena()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def median_wall_ms(torch, fn, reps: int = 10) -> float:
    """The median host wall (ms) of ``reps`` calls timed one by one (each
    ends in a read of its result), after two warm calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def slab_scan_inputs(torch, pool, tid: str, q, k: int) -> list[tuple]:
    """Each shard's ``distance_topk`` call of ``tid``'s search as
    ``tenant_topk`` makes it -> [(gathered rows, their gids, scales,
    prepared queries, k + slack)], a shard each."""
    from repro_torch.core import tenancy as tten
    from repro_torch.core.sharded import normalized

    arena = pool._arena
    _, bl, gi, sc = arena.pack_arena()
    slack = arena.tenant_table(tid)[2]
    out = []
    for s, tbl in enumerate(arena._device_tables(tid)):
        db, g, sg = tten._slab_gather(bl[s], gi[s], None if sc is None
                                      else sc[s], tbl, arena.slab_rows)
        qd = normalized(torch.as_tensor(q, device=db.device)).contiguous()
        out.append((db, g, sg, qd, min(k + slack, db.shape[0])))
    return out


def slab_scan_agree(torch, pool, tid: str, q, k: int) -> list[dict]:
    """Each shard's slab scan of ``tid`` (the tenant's slabs gathered out
    of the shard's block, k + slack rows) through the kernel against the
    plain version on the same gathered rows (``assert_topk_agree``)."""
    from repro_torch.kernels import ops, ref

    l_pad = pool._arena.tenant_table(tid)[1]
    out = []
    for s, (db, g, sg, qd, kk) in enumerate(slab_scan_inputs(
            torch, pool, tid, q, k)):
        got = ops.flat_topk(db, qd, kk, scales=sg)
        want = ref.distance_topk_ref(db, qd, kk, scales=sg)
        frac = assert_topk_agree(torch, got, want,
                                 f"{tid} shard {s} slab scan k {kk}")
        out.append(dict(shard=s, slab_table=l_pad,
                        gathered_rows=db.shape[0],
                        live=int((g >= 0).sum()), k=kk,
                        max_abs_err=(got[0] - want[0]).abs().max().item(),
                        ids_equal_frac=frac))
    return out


def slab_scan_cell(torch, pool, tid: str, q, k: int) -> dict:
    """The slab scan of one tenant at B ``len(q)``: the kernel's device
    ms a launch (profiler) and a call (CUDA events) on the gathered rows,
    the gather + scan + mask of ``tenant_topk`` a call, its bound (the
    gathered rows read once), the plain version's and the library's
    time."""
    from repro_torch.core import tenancy as tten
    from repro_torch.kernels import ops, ref

    cell = slab_scan_agree(torch, pool, tid, q, k)[0]
    db, _, sg, qd, kk = slab_scan_inputs(torch, pool, tid, q, k)[0]
    arena = pool._arena
    _, bl, gi, sc = arena.pack_arena()
    tbl = arena._device_tables(tid)[0]
    slack = arena.tenant_table(tid)[2]
    call = lambda: ops.flat_topk(db, qd, kk, scales=sg)
    b_ms, b_by = topk_bound(db, sg, qd.shape[0], kk)
    cell.update(
        B=qd.shape[0], codec=pool.dtype,
        **device_split(torch, call, "distance_topk", reps=10),
        ms=time_ms(torch, call, 20),
        gather_scan_mask_ms=time_ms(torch, lambda: tten._slab_local_topk(
            bl[0], gi[0], None if sc is None else sc[0], tbl, qd, k=k,
            slack=slack, metric=pool.metric, slab_rows=arena.slab_rows),
            20),
        bound_ms=b_ms, bound_by=b_by,
        plain_ms=time_ms(torch, lambda: ref.distance_topk_ref(
            db, qd, kk, scales=sg), 5, warmup=1),
        library_ms=library_topk_ms(torch, db, sg, qd, kk))
    return cell


def pool_arena(torch, codec: str, x, qs, shards: int = 1) -> dict:
    """(a) / (e): ``POOL_TENANTS`` tenants of ``POOL_ROWS`` rows in one
    pool at ``shards`` shards, every tenant resident: the fill's wall;
    ``POOL_SAMPLE`` sampled tenants' ``query_batch`` (B 8, k 10) against a
    dedicated ``FlatVectorIndex`` on the card and a CPU pool of the
    sampled tenants, each shard's slab scan against its plain version, one
    launch a shard a search; ``query_batch_multi`` at B 128 over 128
    tenants against the per-tenant calls; walls, device bytes, tenants a
    GB."""
    import numpy as np
    from repro_torch.core import IndexPool
    from repro_torch.core.flat import FlatVectorIndex

    cfg = dict(dim=DIM, metric="cosine", dtype=codec,
               slab_rows=POOL_SLAB, max_resident=POOL_TENANTS)
    pool = IndexPool(n_shards=shards, device="cuda", **cfg)
    fill_s = fill_pool(torch, pool, x, POOL_TENANTS, POOL_ROWS)
    sample = list(range(0, POOL_TENANTS, POOL_TENANTS // POOL_SAMPLE))
    cpu = IndexPool(device="cpu", **cfg)
    for j in sample:
        cpu.bulk_insert(f"u{j}", [f"d{i}" for i in range(POOL_ROWS)],
                        x[j * POOL_ROWS:(j + 1) * POOL_ROWS])
    keys = [f"d{i}" for i in range(POOL_ROWS)]
    walls = {"pool": [], "dedicated": []}
    scans = []
    for n, j in enumerate(sample):
        tid = f"u{j}"
        q = qs[(n * POOL_B) % POOL_MULTI_B:][:POOL_B]
        # one launch a shard and pass of 256 (k·rf + the tenant's slack)
        _, l_pad, slack, _ = pool._arena.tenant_table(tid)
        kk = min(10 * (4 if codec == "int8" else 1) + slack,
                 l_pad * POOL_SLAB)
        launches = shards * -(-kk // 256)
        counts = counted(torch, lambda: pool.query_batch(tid, q, k=10))
        assert counts.get(f"kernel.distance_topk.{codec}") == launches, \
            counts
        assert counts.get("kernel.distance_topk") == launches, counts
        got = pool.query_batch(tid, q, k=10)[0]
        ded = FlatVectorIndex(dim=DIM, metric="cosine", dtype=codec,
                              device="cuda")
        ded.bulk_insert(keys, x[j * POOL_ROWS:(j + 1) * POOL_ROWS])
        assert got == ded.query_batch(q, k=10)[0], f"{tid}: != dedicated"
        assert got == cpu.query_batch(tid, q, k=10)[0], f"{tid}: != CPU"
        scans += [dict(cell, tenant=tid) for cell in slab_scan_agree(
            torch, pool, tid, q, 10 * (4 if codec == "int8" else 1))]
        if n < 4:
            walls["pool"].append(median_wall_ms(
                torch, lambda: pool.query_batch(tid, q, k=10)))
            walls["dedicated"].append(median_wall_ms(
                torch, lambda: ded.query_batch(q, k=10)))
        del ded
    # one cross-tenant search over 128 tenants against 128 single calls
    tids = [f"u{j}" for j in range(0, POOL_TENANTS,
                                   POOL_TENANTS // POOL_MULTI_B)]
    counts = counted(torch, lambda: pool.query_batch_multi(qs, tids, k=10))
    mk, md = pool.query_batch_multi(qs, tids, k=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = [pool.query_batch(t, qs[i:i + 1], k=10) for i, t in
              enumerate(tids)]
    single_s = time.perf_counter() - t0
    for i, (sk, sd) in enumerate(single):
        assert mk[i] == sk[0], f"multi row {i} ({tids[i]}) != single"
        assert np.abs(md[i] - sd[0]).max() <= 1e-5
    multi_ms = median_wall_ms(torch, lambda: pool.query_batch_multi(
        qs, tids, k=10), reps=5)
    stats = pool.pool_stats()
    out = dict(
        codec=codec, shards=shards, tenants=POOL_TENANTS,
        rows_a_tenant=POOL_ROWS, dim=DIM, slab_rows=POOL_SLAB,
        fill_s=fill_s, sampled=len(sample),
        keys_equal_dedicated_and_cpu=True, launches_a_search=launches,
        slab_scans_equal_plain=len(scans),
        slab_scan_max_abs_err=max(c["max_abs_err"] for c in scans),
        query_batch_wall_ms={k: statistics.median(v)
                             for k, v in walls.items()},
        multi_B128_wall_ms=multi_ms, multi_counters=counts,
        single_128_calls_wall_ms=single_s * 1e3, multi_keys_equal=True,
        arena_device_bytes=stats["arena_bytes"],
        tenants_a_gb=POOL_TENANTS / (stats["arena_bytes"] / 1e9),
        pool_stats=stats)
    return out, pool


def pool_paging(torch, d: Path) -> tuple[dict, object]:
    """(b): ``PAGE_TENANTS`` int8 tenants of ``PAGE_ROWS`` rows in a pool
    of ``PAGE_RESIDENT`` resident slots over per-tenant stores under
    ``d``, against a pool that never evicts: evict and admit cycles (each
    timed), a mutation a tenant between them, then every tenant's state
    arrays, epoch and keys bit for bit the never-evicted pool's."""
    import numpy as np
    from repro_torch.core import IndexPool

    x, qs = pool_rows(torch, PAGE_TENANTS + 1, PAGE_ROWS, 41)
    extra = x[PAGE_TENANTS * PAGE_ROWS:]
    cfg = dict(dim=DIM, metric="cosine", dtype="int8", slab_rows=POOL_SLAB,
               device="cuda")
    paged = IndexPool(str(d), max_resident=PAGE_RESIDENT, **cfg)
    never = IndexPool(max_resident=PAGE_TENANTS, **cfg)
    fill_s = fill_pool(torch, paged, x, PAGE_TENANTS, PAGE_ROWS, "p")
    fill_pool(torch, never, x, PAGE_TENANTS, PAGE_ROWS, "p")
    tids = [f"p{j}" for j in range(PAGE_TENANTS)]
    evict_ms, admit_ms = [], []
    for cycle in range(2):
        for j, tid in enumerate(tids):
            if tid not in paged.resident_tenants():
                victim = paged.resident_tenants()[0]        # the LRU
                t0 = time.perf_counter()
                paged.evict(victim)
                evict_ms.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                paged.admit(tid)
                admit_ms.append((time.perf_counter() - t0) * 1e3)
            for p in (paged, never):                  # a logged mutation
                p.insert(tid, f"x{cycle}", extra[(j + cycle) % PAGE_ROWS])
                p.delete(tid, f"d{cycle * 7 + j % 5}")
        q = qs[:POOL_B]
        for tid in tids[::8]:
            assert paged.query_batch(tid, q, k=10)[0] == \
                never.query_batch(tid, q, k=10)[0], f"{tid}: paged keys"
    for tid in tids:
        paged.admit(tid)
        a, b = paged._arena.tenant_rows(tid), never._arena.tenant_rows(tid)
        assert a[0] == b[0] and paged.epoch(tid) == never.epoch(tid)
        for u, v in zip(a[1:], b[1:]):
            same = (u is None and v is None) or u.tobytes() == v.tobytes()
            assert same, f"{tid}: paged state differs"
    out = dict(tenants=PAGE_TENANTS, rows_a_tenant=PAGE_ROWS,
               max_resident=PAGE_RESIDENT, fill_s=fill_s,
               cycles=len(evict_ms), bit_for_bit=True,
               evict_ms_median=statistics.median(evict_ms),
               admit_ms_median=statistics.median(admit_ms),
               evict_ms_max=max(evict_ms), admit_ms_max=max(admit_ms),
               stats=dict(paged.stats), store_bytes=dir_bytes(d))
    del never
    return out, (paged, x)


def pool_secure_delete(torch, paged, x, d: Path) -> dict:
    """(c): ``compact`` on one tenant of the paging pool after deleting 32
    of its rows: their fp32, normalized and int8 bytes are in no host
    array of the arena, in no packed block read back from the card and in
    no file of the pool's stores; the other tenants' epochs stay."""
    import numpy as np
    from repro_torch.core.hnsw_build import normalize_rows

    tid = "p1"
    paged.admit(tid)
    keys, _, alive, enc, _ = paged._arena.tenant_rows(tid)
    rows = [r for r, k in enumerate(keys)
            if alive[r] and k.startswith("d")][-32:]
    dead = [keys[r] for r in rows]
    base = x[PAGE_ROWS:2 * PAGE_ROWS]
    needles = []
    for k, r in zip(dead, rows):
        v = base[int(k[1:])]
        needles += [np.ascontiguousarray(v).tobytes(),
                    np.ascontiguousarray(normalize_rows(v[None])[0])
                    .tobytes(), np.ascontiguousarray(enc[r]).tobytes()]
    paged.flush()                              # the rows reach the disk
    for k in dead:
        paged.delete(tid, k)
    others = {t: paged.epoch(t) for t in paged.tenants() if t != tid}
    t0 = time.perf_counter()
    paged.compact(tid)
    compact_s = time.perf_counter() - t0
    arena = paged._arena
    hay = [arena._vecs.tobytes(), arena._enc.tobytes()]
    _, bl, gi, sc = arena.pack_arena()
    hay += [t.cpu().numpy().tobytes() for t in bl]
    files = [p for p in d.rglob("*") if p.is_file()]
    hay += [p.read_bytes() for p in files]
    for n in needles:
        assert all(n not in h for h in hay), "a deleted row's bytes remain"
    assert {t: paged.epoch(t) for t in others} == others
    return dict(tenant=tid, deleted=len(dead), needles=len(needles),
                files_searched=len(files), compact_s=compact_s,
                bytes_absent=True, other_epochs_unchanged=len(others))


def pool_served(torch) -> dict:
    """(d): ``--rag --tenants 4 --max-resident 2 --index-dtype int8
    --store-dir`` at full width, cold and then warm: the warm run restores
    every tenant, inserts nothing and retrieves the cold run's keys, and
    the per-request keys equal a CPU pool's, restored from the stores the
    served pool flushed, on the same queries and tenants."""
    from repro_torch.core import IndexPool

    d = store_dir("pool_serve")
    try:
        argv = ["--tenants", "4", "--max-resident", "2", "--index-dtype",
                "int8", "--store-dir", str(d)]
        runs = {}
        for name in ("cold", "warm"):
            cfg, _, _, res, rec = served_run(torch, argv)
            pool = res["rag"].index
            rec.update(keys=[[doc.key for doc in r.docs]
                             for r in res["reqs"]],
                       tenants=[r.tenant for r in res["reqs"]],
                       epochs={t: pool.epoch(t) for t in pool.tenants()},
                       fill_s=res["fill_seconds"], pool=pool.pool_stats())
            counts = rec["counters"]
            assert counts["kernel.flash_decode"] == \
                cfg.n_layers * rec["engine"]["decode_ticks"]
            log(f"serve --tenants 4 int8 --store-dir, {name} "
                + json.dumps(rec))
            runs[name] = rec
            encoder, queries = res["rag"].encoder, [r.query
                                                    for r in res["reqs"]]
            del res, pool
            release(torch)
        cold, warm = runs["cold"], runs["warm"]
        for what in ("keys", "tenants", "epochs"):
            assert warm[what] == cold[what], f"warm {what} != cold"
        cpu = IndexPool(str(d), dim=encoder.dim, dtype="int8",
                        max_resident=2, device="cpu")
        want = cpu.query_batch_multi(encoder.encode(queries),
                                     cold["tenants"], k=3)[0]
        assert cold["keys"] == want, f"served {cold['keys']} != CPU {want}"
        return {"cold": cold, "warm": warm, "keys_equal_cpu": True}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def phase_tenancy(torch) -> dict:
    """The multi-tenant ``IndexPool``: (a) the arena (fp32 and int8), (b)
    paging, (c) secure delete, (d) the served path, (e) the int8 arena
    at 4 shards on cuda:0 repeated."""
    out = {}
    x, qs = pool_rows(torch, POOL_TENANTS, POOL_ROWS, 37)
    one = {}
    for codec in ("fp32", "int8"):
        out[f"arena_{codec}"], pool = pool_arena(torch, codec, x, qs)
        out[f"arena_{codec}"]["slab_scan"] = slab_scan_cell(
            torch, pool, "u0", qs[:POOL_B], 10 * (4 if codec == "int8"
                                                  else 1))
        log(f"pool arena {codec} " + json.dumps(out[f"arena_{codec}"]))
        if codec == "int8":
            sample = [f"u{j}" for j in range(0, POOL_TENANTS,
                                             POOL_TENANTS // POOL_SAMPLE)]
            one = {t: pool.query_batch(t, qs[:POOL_B], k=10)[0]
                   for t in sample}
        del pool
        release(torch)
    d = store_dir("pool_paging")
    try:
        out["paging"], (paged, xp) = pool_paging(torch, d)
        log("pool paging " + json.dumps(out["paging"]))
        out["secure_delete"] = pool_secure_delete(torch, paged, xp, d)
        log("pool secure delete " + json.dumps(out["secure_delete"]))
        del paged, xp
    finally:
        shutil.rmtree(d, ignore_errors=True)
    release(torch)
    old = shard_env(",".join(["cuda:0"] * SHARDS))
    try:
        rec, pool = pool_arena(torch, "int8", x, qs, shards=SHARDS)
        for t, keys in one.items():
            assert pool.query_batch(t, qs[:POOL_B], k=10)[0] == keys, \
                f"{t} at {SHARDS} shards: keys differ from one shard"
        rec["keys_equal_one_shard"] = True
        rec["slab_scan_per_shard"] = slab_scan_agree(torch, pool, "u0",
                                                     qs[:POOL_B], 40)
        out["sharded"] = rec
        log(f"pool arena int8 {SHARDS} shards " + json.dumps(rec))
        del pool
    finally:
        shard_env(old)
    del x
    release(torch)
    out["served"] = pool_served(torch)
    return out


# ---------------------------------------------------------------------------
# phase 11: the other LMs of launch.serve --arch
# ---------------------------------------------------------------------------
def with_cfg(model, cfg):
    """The same weights under another config (a shallow copy: one set of
    parameters on the card)."""
    twin = copy.copy(model)
    twin.cfg = cfg
    return twin


def flash_served_cell(torch, model, cfg, args) -> dict:
    """(b) ``flash_decode`` at the model's served cache: a prefill of
    slots x (max_len - 1) tokens to live lengths 2-256, the kernel held
    against its plain version on every layer's cache (2e-5) and timed
    cycling through the layers as a tick does, beside its plain version,
    SDPA and the bound; profiler split a launch."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as tf

    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (args.slots, args.max_len - 1),
                         device="cuda", generator=gen)
    lens = torch.tensor([1 + (args.max_len - 2) * i // (args.slots - 1)
                         for i in range(args.slots)], dtype=torch.int32,
                        device="cuda")
    _, cache = tf.prefill(model, toks, max_len=args.max_len, prompt_lens=lens)
    live = lens + 1
    qf = torch.randn(args.slots, cfg.n_heads, cfg.dh, device="cuda",
                     generator=gen)
    mask = (torch.arange(cache.k.shape[2], device="cuda")[None, :]
            < live[:, None])[:, None, None, :]
    err = lib_err = 0.0
    for li in range(cfg.n_layers):
        k, v = cache.k[li], cache.v[li]
        want = ref.flash_decode_ref(qf, k, v, live)
        got = ops.flash_decode(qf, k, v, live)
        lib = F.scaled_dot_product_attention(
            qf[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)[:, :, 0]
        torch.cuda.synchronize()
        err = max(err, (got - want).abs().max().item())
        lib_err = max(lib_err, (lib - want).abs().max().item())
    assert err <= 2e-5, f"flash_decode at {cfg.name}'s served cache: {err}"
    turn = itertools.count()

    def tick(fn):
        def run():
            li = next(turn) % cfg.n_layers
            return fn(cache.k[li], cache.v[li])
        return run

    kernel = tick(lambda k, v: ops.flash_decode(qf, k, v, live))
    split = device_split(torch, kernel, "flash_decode", reps=cfg.n_layers)
    b_ms, b_by = flash_bound(live.tolist(), args.slots, cfg.n_heads,
                             cfg.n_kv_heads, cfg.dh)
    rec = dict(
        max_abs_err=err, ms=time_ms(torch, kernel, 4 * cfg.n_layers),
        plain_ms=time_ms(torch, tick(
            lambda k, v: ref.flash_decode_ref(qf, k, v, live)), cfg.n_layers),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, tick(
            lambda k, v: F.scaled_dot_product_attention(
                qf[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)), 4 * cfg.n_layers),
        library_max_abs_err=lib_err, **split,
        shapes=f"B {args.slots}, H {cfg.n_heads}, KVH {cfg.n_kv_heads}, "
               f"G {cfg.n_heads // cfg.n_kv_heads}, Dh {cfg.dh}, S "
               f"{cache.k.shape[2]} f32, cur_len {live.tolist()}, "
               f"{cfg.n_layers} layer caches cycled")
    # (c) one full-width decode_step: the flash kernel and the dense path
    nxt = toks[torch.arange(args.slots, device="cuda"), lens.long() - 1]
    logits = {}
    for impl in ("flash", "dense"):
        c = tf.KVCache(cache.k.clone(), cache.v.clone(), cache.cur_len.clone())
        logits[impl], _ = tf.decode_step(model, nxt[:, None], c,
                                         attn_impl=impl)
    lf, ld = logits["flash"], logits["dense"]
    assert lf.shape == (args.slots, 1, cfg.vocab)
    assert bool(torch.isfinite(lf).all())
    torch.testing.assert_close(lf, ld, rtol=1e-3, atol=1e-3)
    assert bool((lf.argmax(-1) == ld.argmax(-1)).all())
    rec["decode_step_flash_vs_dense_max_abs_diff"] = (lf - ld).abs().max(
        ).item()
    return rec


def moe_layer_cell(torch, model, cfg) -> dict:
    """(d) Layer 0's MoE on 256 tokens on the card and on the CPU with the
    same weights: router ids and the keep mask equal wherever the k-th
    probability clears the (k+1)-th by 1e-5 (>= 99 % of tokens), outputs
    within 1e-4 there, two card runs equal bit for bit; the layer timed
    at 256 tokens and at a decode tick's slots."""
    from repro_torch.models import moe as tmoe

    mc, k = cfg.moe, cfg.moe.top_k
    card = model.layers[0].moe
    cpu = copy.deepcopy(card).cpu()
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(MOE_TOKENS, cfg.d_model, device="cuda", generator=gen)
    xc = x.cpu()
    probs, _, ids, _, keep = tmoe.route(cpu, mc, xc)
    _, _, ids_d, _, keep_d = tmoe.route(card, mc, x)
    top = torch.sort(probs, dim=-1, descending=True).values
    ok = (top[:, k - 1] - top[:, k]) > 1e-5
    share = ok.float().mean().item()
    assert share >= 0.99, f"{cfg.name}: {share:.4f} of tokens clear ties"
    ids_eq = bool(torch.equal(ids_d.cpu()[ok], ids[ok]))
    keep_eq = bool(torch.equal(keep_d.cpu().reshape(-1, k)[ok],
                               keep.reshape(-1, k)[ok]))
    assert ids_eq and keep_eq, f"{cfg.name}: routing differs from the CPU"
    out, aux = tmoe.moe_ffn(cpu, mc, xc)
    out_d, aux_d = tmoe.moe_ffn(card, mc, x)
    again, aux_again = tmoe.moe_ffn(card, mc, x)
    err = (out_d.cpu()[ok] - out[ok]).abs().max().item()
    assert err <= 1e-4, f"{cfg.name}: MoE output err {err}"
    assert torch.equal(again, out_d) and torch.equal(aux_again, aux_d)
    x4 = x[:4]
    rec = dict(tokens=MOE_TOKENS, clear_of_ties=share, ids_equal=ids_eq,
               keep_equal=keep_eq, dropped=int((~keep).sum()),
               capacity=tmoe.capacity(MOE_TOKENS, mc),
               max_abs_err=err, aux=aux_d.item(),
               aux_abs_err=abs(aux_d.item() - aux.item()),
               bit_for_bit_twice=True,
               ms=time_ms(torch, lambda: tmoe.moe_ffn(card, mc, x), 5),
               decode_tick_ms=time_ms(torch, lambda: tmoe.moe_ffn(
                   card, mc, x4), 10),
               decode_tick_capacity=tmoe.capacity(4, mc),
               expert_bytes_a_layer=sum(
                   w.numel() * 4 for w in (card.we1, card.we2, card.we3)))
    del cpu
    return rec


def ring_cell(torch, model, cfg) -> dict:
    """(e) h2o-danube-3-4b's ring at full width: B 2, a 4,608-token prompt
    (past the 4,096 window: the prefill rolls), then 64 teacher-forced
    decode ticks that wrap the ring, flash and dense at every tick; the
    last tick's logits against a prefill of all 4,672 tokens."""
    from repro_torch.models import transformer as tf

    total = RING_PROMPT + RING_STEPS
    gen = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (RING_B, total), device="cuda",
                         generator=gen)
    t0 = time.perf_counter()
    _, cache = tf.prefill(model, toks[:, :RING_PROMPT], max_len=total)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    assert cache.k.shape[2] == cfg.sliding_window == tf.cache_len(cfg, total)
    caches = {"flash": cache,
              "dense": tf.KVCache(cache.k.clone(), cache.v.clone(),
                                  cache.cur_len.clone())}
    step_diff = 0.0
    for t in range(RING_PROMPT, total):
        out = {}
        for impl in ("flash", "dense"):
            out[impl], caches[impl] = tf.decode_step(
                model, toks[:, t:t + 1], caches[impl], attn_impl=impl)
        torch.testing.assert_close(out["flash"], out["dense"], rtol=1e-3,
                                   atol=1e-3)
        step_diff = max(step_diff,
                        (out["flash"] - out["dense"]).abs().max().item())
    last = out["flash"]
    del caches, cache
    full, _ = tf.prefill(model, toks)
    diff = (last - full).abs().max().item()
    torch.testing.assert_close(last, full, rtol=1e-3, atol=1e-3)
    assert bool((last.argmax(-1) == full.argmax(-1)).all())
    return dict(batch=RING_B, prompt=RING_PROMPT, ticks=RING_STEPS,
                ring=cfg.sliding_window, prefill_s=prefill_s,
                flash_vs_dense_max_abs_diff=step_diff,
                last_vs_full_prefill_max_abs_diff=diff,
                max_abs_logit=full.abs().max().item(),
                tolerance="rtol 1e-3, atol 1e-3; argmax equal")


def kv_quant_cell(torch, model, cfg) -> dict:
    """(f) the int8 cache of ``model`` (a kv_quant config): one layer's
    payload and scales from a card prefill equal the CPU quantization of
    the same fp32 K/V exactly; 16 teacher-forced decode ticks through the
    flash kernel agree with the dense path from the same int8 cache at
    every tick (rtol, atol 1e-3), and their gap to the fp32 cache's decode is measured
    beside the reference's bound for its smoke test (0.02 max|logit| +
    0.01). The bound is not asserted at full width: the reference's own
    int8 scheme leaves it there (its gap grows with d_model;
    tests/test_torch_lm_family.py holds the port's gap to the
    reference's)."""
    from repro_torch.models import transformer as tf

    fp32 = with_cfg(model, dataclasses.replace(cfg, kv_quant=False))
    gen = torch.Generator(device="cuda").manual_seed(5)
    total = KVQ_PROMPT + KVQ_STEPS
    toks = torch.randint(0, cfg.vocab, (2, total), device="cuda",
                         generator=gen)
    lq, cq = tf.prefill(model, toks[:, :KVQ_PROMPT], max_len=total)
    lf, cf = tf.prefill(fp32, toks[:, :KVQ_PROMPT], max_len=total)
    assert cq.k.dtype == torch.int8 and cq.k_scale is not None
    for pay, scale, x in ((cq.k[0], cq.k_scale[0], cf.k[0]),
                          (cq.v[0], cq.v_scale[0], cf.v[0])):
        want_q, want_s = tf._quantize_kv(x.cpu())
        assert torch.equal(pay.cpu(), want_q), "int8 payload != CPU's"
        assert torch.equal(scale.cpu(), want_s), "int8 scales != CPU's"
    gaps, dense_diff = [(lq - lf).abs().max().item()], 0.0
    scale = lf.abs().max().item()
    for t in range(KVQ_PROMPT, total):
        tok = toks[:, t:t + 1]
        # the dense path from the same cache: the two caches would drift
        # apart (a new row on a rounding edge takes either int8 step)
        cd = tf.KVCache(cq.k.clone(), cq.v.clone(), cq.cur_len.clone(),
                        cq.k_scale.clone(), cq.v_scale.clone())
        lq, cq = tf.decode_step(model, tok, cq)
        ld, _ = tf.decode_step(model, tok, cd, attn_impl="dense")
        lf, cf = tf.decode_step(fp32, tok, cf)
        torch.testing.assert_close(lq, ld, rtol=1e-3, atol=1e-3)
        dense_diff = max(dense_diff, (lq - ld).abs().max().item())
        gaps.append((lq - lf).abs().max().item())
        scale = max(scale, lf.abs().max().item())
    bound = 0.02 * scale + 0.01
    return dict(prompt=KVQ_PROMPT, ticks=KVQ_STEPS, layer0_exact=True,
                flash_vs_dense_max_abs_diff=dense_diff,
                gap_to_fp32_cache_by_tick=gaps, max_gap=max(gaps),
                max_abs_logit=scale, reference_bound=bound,
                within_reference_bound=max(gaps) < bound,
                cache_bytes_int8=sum(t.numel() * t.element_size() for t in (
                    cq.k, cq.v, cq.k_scale, cq.v_scale)),
                cache_bytes_fp32=sum(t.numel() * 4 for t in (cf.k, cf.v)))


def served_other_lm(torch, cfg, flat_keys, what: str) -> tuple:
    """(a) ``--rag --index flat --index-dtype int8`` at full width:
    ``flash_decode`` once a layer a tick, ``distance_topk`` (int8) once a
    search, the keys phase 4 served; one decode tick's wall and device
    ms. Returns (model, args, record)."""
    _, args, _, res, out = served_run(
        torch, ["--index", "flat", "--index-dtype", "int8"], cfg=cfg)
    counts, es, rs = out["counters"], out["engine"], out["retrieval"]
    assert counts["kernel.flash_decode"] == cfg.n_layers * es["decode_ticks"]
    assert counts.get("kernel.distance_topk.int8", 0) == rs["searches"] > 0
    got = [[d.key for d in r.docs] for r in res["reqs"]]
    assert got == flat_keys, f"{what}: served keys {got} != phase 4's"
    model = res["engine"].model
    out["profile"] = profile_decode(torch, model, cfg, args)
    log(f"serve {what} " + json.dumps(out))
    return model, args, out


def phase_other_lms(torch, flat_keys) -> dict:
    """Each of the other LMs at its published config, one at a time."""
    from repro_torch.configs import get_config

    out = {}
    for arch in OTHER_LMS:
        t0 = time.perf_counter()
        cfg = get_config(arch).model
        log(f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
            f"{cfg.n_heads}/{cfg.n_kv_heads}, Dh {cfg.dh}, vocab "
            f"{cfg.vocab}, window {cfg.sliding_window}, moe {cfg.moe}")
        model, args, rec = served_other_lm(torch, cfg, flat_keys, arch)
        rec["flash_served"] = flash_served_cell(torch, model, cfg, args)
        log(f"{arch} flash_decode at the served cache, decode_step flash vs "
            "dense " + json.dumps(rec["flash_served"]))
        if cfg.moe is not None:
            rec["moe_layer"] = moe_layer_cell(torch, model, cfg)
            log(f"{arch} MoE layer card vs CPU "
                + json.dumps(rec["moe_layer"]))
        if cfg.sliding_window is not None:
            rec["ring"] = ring_cell(torch, model, cfg)
            log(f"{arch} ring " + json.dumps(rec["ring"]))
            del model
            release(torch)
            qcfg = dataclasses.replace(cfg, kv_quant=True)
            model, _, rec["kv_quant_served"] = served_other_lm(
                torch, qcfg, flat_keys, f"{arch} kv_quant")
            rec["kv_quant"] = kv_quant_cell(torch, model, qcfg)
            log(f"{arch} kv_quant " + json.dumps(rec["kv_quant"]))
        del model
        rec["seconds"] = time.perf_counter() - t0
        log(f"{arch}: {rec['seconds']:.1f}s, {release(torch):.2f} GB still "
            "allocated")
        out[arch] = rec
    return out

# ---------------------------------------------------------------------------
# phase 12: bf16 weights, activations and cache
# ---------------------------------------------------------------------------
def flash_bf16_cells(torch) -> dict:
    """(a) phase 2's llama3-8b cells, then each other LM's served cache."""
    from repro_torch.configs import get_config

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(12)
    cells = {name: flash_cell(torch, name, b, s, lens, layers, DEC_H,
                              DEC_KVH, dh, gen, bf)
             for name, (b, s, lens, layers, dh) in FLASH_CELLS.items()}
    _, s, lens, _, _ = FLASH_CELLS["served"]
    for arch in OTHER_LMS:
        cfg = get_config(arch).model
        cells[arch] = flash_cell(torch, arch, len(lens), s, lens,
                                 cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.dh, gen, bf)
    return cells


def served_bf16(torch, cfg, model, flat_keys) -> tuple:
    """(b) phase 4's served path with ``model`` (bf16 weights) behind
    ``ServeEngine(dtype=torch.bfloat16)``: the flat int8 index over the
    same corpus, 8 requests, 16 new tokens, 4 slots, the counters zeroed
    before the index is filled and read after the last request. Returns
    (args, record)."""
    from repro_torch.core import dispatch
    from repro_torch.data.corpus import BUILTIN_CORPUS
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.rag import RAGPipeline

    args = serve.parse_args(
        ["--rag", "--index", "flat", "--index-dtype", "int8", "--requests",
         "8", "--max-new", "16", "--slots", "4", "--max-len", "256",
         "--seed", "0", "--device", "cuda"])
    corpus = list(BUILTIN_CORPUS) + synthetic_corpus(SYNTHETIC_DOCS,
                                                     args.seed)
    t0 = time.perf_counter()
    dispatch.reset()
    rag = RAGPipeline(index_kind="flat", index_dtype="int8",
                      retrieval_batch=args.retrieval_batch,
                      retrieval_cache=args.retrieval_cache, device="cuda")
    rag.add_documents(corpus)
    eng = ServeEngine(model, cfg, pipeline=rag, slots=args.slots,
                      max_len=args.max_len, dtype=torch.bfloat16,
                      seed=args.seed, device="cuda")
    queries = [serve.QUERIES[i % len(serve.QUERIES)]
               for i in range(args.requests)]
    reqs, dt = serve._serve_closed_loop(eng, queries, [None] * len(queries),
                                        k=3, max_new=args.max_new)
    torch.cuda.synchronize()
    counts = dispatch.snapshot()
    es, rs = eng.stats.as_dict(), rag.retriever.stats.as_dict()
    assert all(r.done and len(r.out_tokens) == args.max_new for r in reqs)
    assert eng.cache.k.dtype == torch.bfloat16
    got = [[d.key for d in r.docs] for r in reqs]
    assert got == flat_keys, f"bf16 served keys {got} != phase 4's"
    ticks = es["decode_ticks"]
    assert counts["kernel.flash_decode.bf16"] == cfg.n_layers * ticks \
        == counts["kernel.flash_decode"], counts
    assert counts.get("kernel.distance_topk.int8", 0) == rs["searches"] > 0
    rec = dict(requests=len(reqs), tokens=eng.tokens_out, seconds=dt,
               req_per_s=len(reqs) / dt, tok_per_s=eng.tokens_out / dt,
               setup_and_serve_s=time.perf_counter() - t0,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               engine=es, retrieval=rs, counters=counts, keys=got)
    return args, rec


def bf16_decode_cell(torch, model, cfg, args) -> tuple[dict, dict]:
    """(c) and (d) on one input: a prefill of slots x (max_len - 1) tokens
    to live lengths 2-256, then one full-width ``decode_step``. (c) bf16,
    flash against dense from one cache: layer 0's attention output (fp32,
    before its bf16 cast) kernel against plain within 2e-5. (d) the same
    weights widened to an fp32 model (loaded from the bf16 state), its own
    fp32 prefill and decode: the bf16 model's prefill and decode logits
    against it, logged. The two bf16 paths must be closer to each other
    than bf16 is to fp32: a bf16 rounding of their attention outputs
    (fp32 sums in another order) is carried 32 layers on, so their argmax
    may part where the top-2 margin is small; rows, margins and gaps are
    logged."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import rms_norm

    gen = torch.Generator(device="cuda").manual_seed(13)
    toks = torch.randint(0, cfg.vocab, (args.slots, args.max_len - 1),
                         device="cuda", generator=gen)
    lens = torch.tensor([1 + (args.max_len - 2) * i // (args.slots - 1)
                         for i in range(args.slots)], dtype=torch.int32,
                        device="cuda")
    pre16, cache = tf.prefill(model, toks, max_len=args.max_len,
                              prompt_lens=lens)
    assert cache.k.dtype == torch.bfloat16
    nxt = toks[torch.arange(args.slots, device="cuda"), lens.long() - 1]
    # layer 0 as decode_step runs it: the new token's q and K/V row
    x = tf._embed(model, nxt[:, None], torch.bfloat16)
    h = rms_norm(x, model.layers[0].attn_norm, cfg.norm_eps)
    q, k_new, v_new = tf._qkv(model.layers[0], cfg, h, lens[:, None])
    k0, v0 = cache.k[0].clone(), cache.v[0].clone()
    b_idx = torch.arange(args.slots, device="cuda")
    k0[b_idx, lens.long()] = k_new[:, 0]
    v0[b_idx, lens.long()] = v_new[:, 0]
    q0 = q[:, 0].contiguous()
    a_kernel = ops.flash_decode(q0, k0, v0, lens + 1)
    a_plain = ref.flash_decode_ref(q0, k0, v0, lens + 1)
    torch.cuda.synchronize()
    layer0_err = (a_kernel - a_plain).abs().max().item()
    assert layer0_err <= 2e-5, f"bf16 layer 0 attention: {layer0_err}"
    logits = {}
    for impl in ("flash", "dense"):
        c = tf.KVCache(cache.k.clone(), cache.v.clone(), cache.cur_len.clone())
        logits[impl], _ = tf.decode_step(model, nxt[:, None], c,
                                         attn_impl=impl)
        logits[impl] = logits[impl][:, 0]
    del cache
    wide = tf.LM(cfg, device="meta").to_empty(device="cuda")
    wide.load_state_dict(model.state_dict())
    wide.requires_grad_(False)
    pre32, c32 = tf.prefill(wide, toks, max_len=args.max_len,
                            prompt_lens=lens)
    l32, _ = tf.decode_step(wide, nxt[:, None], c32)
    del wide, c32
    lf, ld, l32 = logits["flash"], logits["dense"], l32[:, 0]
    assert lf.dtype == torch.float32 and lf.shape == (args.slots, cfg.vocab)
    assert bool(torch.isfinite(lf).all())

    def gap(a, b):
        return (a - b).abs().max().item()

    top2 = torch.topk(ld, 2, dim=-1).values
    paths, to_fp32 = gap(lf, ld), min(gap(lf, l32), gap(ld, l32))
    assert paths < to_fp32, (paths, to_fp32)
    dec = dict(layer0_attention_kernel_vs_plain_max_abs_err=layer0_err,
               logits_flash_vs_dense_max_abs_diff=paths,
               flash_vs_fp32=gap(lf, l32), dense_vs_fp32=gap(ld, l32),
               max_abs_logit=ld.abs().max().item(),
               argmax_equal_rows=(lf.argmax(-1) == ld.argmax(-1)).tolist(),
               top2_margin=(top2[:, 0] - top2[:, 1]).tolist(),
               live=(lens + 1).tolist())
    cost = dict(prefill_max_abs_diff=gap(pre16, pre32),
                prefill_mean_abs_diff=(pre16 - pre32).abs().mean().item(),
                decode_max_abs_diff=gap(lf, l32),
                max_abs_logit_fp32=max(pre32.abs().max().item(),
                                       l32.abs().max().item()),
                prefill_argmax_agree=(pre16.argmax(-1) == pre32.argmax(-1)
                                      ).float().mean().item(),
                decode_argmax_agree=(lf.argmax(-1) == l32.argmax(-1)
                                     ).float().mean().item(),
                tokens=f"{args.slots} x {args.max_len - 1}, live "
                       f"{(lens + 1).tolist()}")
    return dec, cost


def bf16_kv_quant_cell(torch) -> dict:
    """(e) the reference's ``decode_32k`` shape: h2o-danube-3-4b at full
    width, depth cut to 4 layers, bf16 weights and the int8 cache: 16
    teacher-forced ticks, flash against dense from the same int8 cache,
    the dequantized K/V handed to ``flash_decode`` in bf16 (its bf16
    instance, once a layer a tick). At each tick the two paths' logits
    must be closer to each other than to the same weights widened to fp32
    (their own int8 cache): at bf16 a rounding of the attention output
    moves the logits by bf16's noise, not phase 11's 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_config("h2o-danube-3-4b").model,
                              n_layers=BF16_KVQ_LAYERS, kv_quant=True)
    model = tf.init_lm(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    wide = tf.LM(cfg, device="meta").to_empty(device="cuda")
    wide.load_state_dict(model.state_dict())
    wide.requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(15)
    total = KVQ_PROMPT + KVQ_STEPS
    toks = torch.randint(0, cfg.vocab, (2, total), device="cuda",
                         generator=gen)
    _, cq = tf.prefill(model, toks[:, :KVQ_PROMPT], max_len=total)
    _, c32 = tf.prefill(wide, toks[:, :KVQ_PROMPT], max_len=total)
    assert cq.k.dtype == torch.int8
    paths, to_fp32 = [], []
    for t in range(KVQ_PROMPT, total):
        tok = toks[:, t:t + 1]
        cd = tf.KVCache(cq.k.clone(), cq.v.clone(), cq.cur_len.clone(),
                        cq.k_scale.clone(), cq.v_scale.clone())
        dispatch.reset()
        lq, cq = tf.decode_step(model, tok, cq)
        assert dispatch.get("kernel.flash_decode.bf16") == cfg.n_layers \
            == dispatch.get("kernel.flash_decode")
        ld, _ = tf.decode_step(model, tok, cd, attn_impl="dense")
        l32, c32 = tf.decode_step(wide, tok, c32)
        assert bool(torch.isfinite(lq).all())
        paths.append((lq - ld).abs().max().item())
        to_fp32.append((lq - l32).abs().max().item())
        assert paths[-1] < to_fp32[-1], (t, paths[-1], to_fp32[-1])
    del model, wide
    return dict(layers=cfg.n_layers, reduced="depth 24 -> 4 layers",
                prompt=KVQ_PROMPT, ticks=KVQ_STEPS,
                flash_vs_dense_max_abs_diff=max(paths),
                flash_vs_dense_by_tick=paths,
                bf16_vs_fp32_by_tick=to_fp32,
                flash_instance="bf16 (dequantized K/V)")


def bf16_moe_cell(torch) -> dict:
    """(f) olmoe-1b-7b's layer 0 MoE (its published widths) with bf16
    weights on 256 bf16 tokens, card against CPU with the same weights:
    router ids and the keep mask equal wherever the k-th probability
    clears the (k+1)-th by 1e-5 (>= 99 % of tokens); the bf16 outputs'
    gap logged."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as tmoe

    cfg = get_config("olmoe-1b-7b").model
    mc, k = cfg.moe, cfg.moe.top_k
    card = tmoe.MoE(cfg.d_model, mc, device="cuda", dtype=torch.bfloat16)
    card.reset_parameters(torch.Generator(device="cuda").manual_seed(16),
                          cfg.n_layers)
    card.requires_grad_(False)
    cpu = copy.deepcopy(card).cpu()
    gen = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randn(MOE_TOKENS, cfg.d_model, device="cuda",
                    generator=gen).to(torch.bfloat16)
    xc = x.cpu()
    probs, _, ids, _, keep = tmoe.route(cpu, mc, xc)
    _, _, ids_d, _, keep_d = tmoe.route(card, mc, x)
    top = torch.sort(probs, dim=-1, descending=True).values
    ok = (top[:, k - 1] - top[:, k]) > 1e-5
    share = ok.float().mean().item()
    assert share >= 0.99, f"bf16 MoE: {share:.4f} of tokens clear ties"
    assert torch.equal(ids_d.cpu()[ok], ids[ok])
    assert torch.equal(keep_d.cpu().reshape(-1, k)[ok],
                       keep.reshape(-1, k)[ok])
    out, _ = tmoe.moe_ffn(cpu, mc, xc)
    out_d, _ = tmoe.moe_ffn(card, mc, x)
    assert out_d.dtype == torch.bfloat16
    gap = (out_d.float().cpu()[ok] - out.float()[ok]).abs().max().item()
    return dict(tokens=MOE_TOKENS, clear_of_ties=share, ids_equal=True,
                keep_equal=True, out_max_abs_diff=gap,
                max_abs_out=out.float().abs().max().item(),
                ms=time_ms(torch, lambda: tmoe.moe_ffn(card, mc, x), 5))


def phase_bf16(torch, flat_keys) -> dict:
    """bf16 on the card: (a) the kernel's cells, (b)-(d) llama3-8b with
    bf16 weights, (e) danube's int8 cache at bf16, (f) olmoe's MoE."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf

    out = {"cells": flash_bf16_cells(torch)}
    cfg = get_config("llama3-8b").model
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tf.init_lm(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"llama3-8b bf16 weights: {cfg.n_layers} layers, "
        f"{sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f}"
        f" GB, built in {time.perf_counter() - t0:.1f}s")
    args, out["served"] = served_bf16(torch, cfg, model, flat_keys)
    out["served"]["profile"] = profile_decode(torch, model, cfg, args)
    log("serve llama3-8b bf16 " + json.dumps(out["served"]))
    out["decode_step"], out["cost_vs_fp32"] = bf16_decode_cell(
        torch, model, cfg, args)
    log("bf16 decode_step flash vs dense " + json.dumps(out["decode_step"]))
    log("bf16 vs fp32 logits " + json.dumps(out["cost_vs_fp32"]))
    del model
    release(torch)
    out["kv_quant"] = bf16_kv_quant_cell(torch)
    log("danube bf16 kv_quant " + json.dumps(out["kv_quant"]))
    release(torch)
    out["moe"] = bf16_moe_cell(torch)
    log("olmoe bf16 MoE layer card vs CPU " + json.dumps(out["moe"]))
    # the record of the served bf16 path: the served cache's cell, every
    # other cell beside it
    out["flash"] = dict(out["cells"]["served"], cells=out["cells"])
    return out


# ---------------------------------------------------------------------------
# phase 13: the off-path models
# ---------------------------------------------------------------------------
def build_sage_graph(out_dir: str) -> None:
    """minibatch_lg's graph by ``data.synthetic.make_graph`` on the host,
    in a process of its own (started before phase 10, so that the host
    build, ~100 s, overlaps phases 10 to 12): the CSR, features and labels saved
    under ``out_dir`` as ``.npy``, the build's seconds in ``graph.json``."""
    import numpy as np
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_graph

    dims = {s.name: s for s in get_config("graphsage-reddit").shapes}
    shape = dims["minibatch_lg"]
    t0 = time.perf_counter()
    g = make_graph(shape["n_nodes"], SAGE_DEGREE, shape["d_feat"],
                   shape["n_classes"], seed=0)
    build_s = time.perf_counter() - t0
    out = Path(out_dir)
    for name in ("row_ptr", "col_idx", "feats", "labels"):
        np.save(out / f"{name}.npy", getattr(g, name))
    (out / "graph.json").write_text(json.dumps(
        {"make_graph_s": build_s, "edges": int(g.col_idx.shape[0]),
         "save_s": time.perf_counter() - t0 - build_s}))


def spawn(name: str, jobs: list[tuple]) -> tuple[list, Path]:
    """Start each ``(fn, *args)`` of ``jobs`` as ``fn(directory, *args)``
    in a spawned process, ``directory`` a new store dir -> (processes,
    directory)."""
    import multiprocessing

    d = store_dir(name)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(str(d), *args))
             for fn, *args in jobs]
    for p in procs:
        p.start()
    return procs, d


def stop_spawned(handle) -> None:
    """Stop the processes of ``spawn`` that still run, and remove their
    directory."""
    procs, d = handle
    for proc in procs:
        if proc.is_alive():
            proc.terminate()
        proc.join(timeout=30)
    shutil.rmtree(d, ignore_errors=True)


def near_cpu(torch, got, want, what: str) -> dict:
    """Card against CPU: finite, the same shape, within 1e-4 x max|value|
    -> {max_abs_err, scale}."""
    got, want = got.float().cpu(), want.float()
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    assert bool(torch.isfinite(got).all()), f"{what}: not finite"
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= 1e-4 * scale, f"{what}: card vs CPU {err} (scale {scale})"
    return {"max_abs_err": err, "scale": scale}


def step_times(torch, fn, reps: int = 5) -> dict:
    """A served step's wall ms (host clock, synchronized a call), device
    ms (queued behind a spin kernel) and peak GB (weights included)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    return {"wall_ms": wall, "device_ms": queued_ms(torch, fn, reps),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def recsys_inputs(kind: str, cfg, b: int, seed: int):
    """A serve step's numpy inputs from ``data.synthetic``: fm and
    wide-deep ``ctr_batches`` (ids, dense), bert4rec
    ``masked_item_batches`` (the item sequence), mind ``seq_rec_batches``
    (behaviour, mask)."""
    from repro_torch.data import synthetic

    if kind in ("fm", "wide_deep"):
        bt = next(synthetic.ctr_batches(cfg.n_sparse, cfg.rows_per_field,
                                        cfg.n_dense, b, seed=seed))
        return bt["sparse_ids"], bt["dense"]
    if kind == "bert4rec":
        bt = next(synthetic.masked_item_batches(cfg.n_items, cfg.seq_len, b,
                                                seed=seed))
        return (bt["item_seq"],)
    bt = next(synthetic.seq_rec_batches(cfg.n_items, cfg.seq_len, b,
                                        seed=seed))
    return bt["behavior"], bt["behavior_mask"]


def retrieval_cand(torch, params, cfg, behavior, mask) -> tuple[dict, dict]:
    """launch/steps.py's retrieval_cand: one MIND user's interests against
    its item table, ``FlatIndex.build(items, metric="ip").query(k=100)``,
    one ``distance_topk`` launch (counted), held against the plain version
    on the same rows and timed beside it, ``torch.mm`` + ``torch.topk``
    and the bound -> (record, counters)."""
    from repro_torch.core import dispatch
    from repro_torch.core.flat import FlatIndex
    from repro_torch.kernels import ops, ref
    from repro_torch.models import recsys as trs

    k = RETRIEVAL_K
    interests = trs.mind_user_embedding(
        params, cfg, torch.from_numpy(behavior[:1]).cuda(),
        torch.from_numpy(mask[:1]).cuda())[0]
    qn = interests.cpu().numpy()
    t0 = time.perf_counter()
    index = FlatIndex.build(params["items"].cpu().numpy(), metric="ip")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    dispatch.reset()
    t0 = time.perf_counter()
    d, i = index.query(qn, k=k)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = dispatch.snapshot()
    assert counts.get("kernel.distance_topk", 0) == 1, counts
    db, q = index.vectors, torch.from_numpy(qn).cuda()
    rd, ri = ref.distance_topk_ref(db, q, k, metric="ip")
    frac = assert_topk_agree(torch, (d, i), (rd, ri), "retrieval_cand")
    b_ms, b_by = topk_bound(db, None, q.shape[0], k)
    rec = dict(
        B=q.shape[0], k=k, rows=index.n, dim=db.shape[1],
        interests_identical=bool(torch.equal(
            interests, interests[:1].expand_as(interests))),
        ids_equal_rows=frac, exact=bool(torch.equal(i, ri)
                                        and torch.equal(d, rd)),
        max_abs_err=(d - rd).abs().max().item(), index_build_s=build_s,
        query_wall_ms=wall_ms,
        ms=time_ms(torch, lambda: ops.flat_topk(db, q, k, metric="ip"), 20),
        plain_ms=time_ms(torch, lambda: ref.distance_topk_ref(
            db, q, k, metric="ip"), 5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=library_topk_ms(torch, db, None, q, k, metric="ip"),
        library="torch.mm (TF32 off) + torch.topk on the item rows",
        shapes=f"db {index.n}x{db.shape[1]} fp32 (MIND's item table), "
               f"ip, B {q.shape[0]} (one user's interests), k {k}",
        **device_split(torch, lambda: ops.flat_topk(db, q, k, metric="ip"),
                       "distance_topk"))
    return rec, counts


def recsys_model(torch, arch: str) -> dict:
    """One recsys model at its published config, random weights from a
    seeded CUDA generator: its serve step (``SERVE_STEP``) at serve_p99
    on the card and on the CPU with the same weights and inputs, timed;
    fm and wide-deep also at serve_bulk (timed, finite); mind also
    ``retrieval_cand``."""
    from repro_torch.configs import get_config
    from repro_torch.models import recsys as trs
    from repro_torch.models.common import tree_tensors, tree_to

    conf = get_config(arch)
    cfg, shapes = conf.model, {s.name: s for s in conf.shapes}
    kind = cfg.kind
    fn = getattr(trs, SERVE_STEP[kind])
    t0 = time.perf_counter()
    params = trs.INIT[kind](cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0, "step": SERVE_STEP[kind],
           "weights_gb": sum(t.numel() * t.element_size()
                             for t in tree_tensors(params)) / 1e9}
    for shape in ("serve_p99", "serve_bulk"):
        if shape == "serve_bulk" and kind not in ("fm", "wide_deep"):
            continue
        b = shapes[shape]["batch"]
        host = recsys_inputs(kind, cfg, b, seed=1)
        args = [torch.from_numpy(a).cuda() for a in host]
        got = fn(params, cfg, *args)
        rec = {"B": b, "out_shape": list(got.shape),
               **step_times(torch, lambda: fn(params, cfg, *args))}
        if shape == "serve_p99":
            t0 = time.perf_counter()
            cpu = tree_to(params, "cpu")
            want = fn(cpu, cfg, *(torch.from_numpy(a) for a in host))
            rec.update(near_cpu(torch, got, want, f"{arch} {shape}"),
                       cpu_s=time.perf_counter() - t0)
            del cpu, want
        else:
            assert bool(torch.isfinite(got).all()), f"{arch} {shape}"
        out[shape] = rec
        log(f"{arch} {shape} " + json.dumps(rec))
        if kind == "mind":
            out["retrieval_cand"], out["counters"] = retrieval_cand(
                torch, params, cfg, *host)
            log("mind retrieval_cand " + json.dumps(out["retrieval_cand"]))
        del got, args
    return out


def sage_full_graph_sm(torch, cfg, shape) -> dict:
    """full_graph_sm through ``sage_full_forward``: twice on the card,
    equal bit for bit (no float atomics), and near the CPU. The graph is
    ``make_graph`` at degree ceil(E / N), its edge list cut to the
    published E."""
    from repro_torch.data.synthetic import make_graph
    from repro_torch.models import gnn as tgnn
    from repro_torch.models.common import tree_to

    n, e = shape["n_nodes"], shape["n_edges"]
    g = make_graph(n, -(-e // n), shape["d_feat"], shape["n_classes"],
                   seed=2)
    host = [torch.from_numpy(a) for a in (g.feats, g.edge_src[:e],
                                          g.edge_dst[:e])]
    args = [a.cuda() for a in host]
    params = tgnn.init_sage(cfg, shape["d_feat"], shape["n_classes"],
                            seed=1, device="cuda")
    runs = [tgnn.sage_full_forward(params, cfg, *args) for _ in range(2)]
    assert torch.equal(runs[0], runs[1]), "full_graph_sm: two runs differ"
    want = tgnn.sage_full_forward(tree_to(params, "cpu"), cfg, *host)
    return {"nodes": n, "edges": e, "runs_bit_equal": True,
            **near_cpu(torch, runs[0], want, "full_graph_sm"),
            "call_ms": time_ms(torch, lambda: tgnn.sage_full_forward(
                params, cfg, *args), 10)}


def sage_molecule(torch, cfg, shape) -> dict:
    """molecule (128 graphs x 30 nodes) through ``sage_molecule_forward``,
    card against CPU."""
    from repro_torch.data.synthetic import molecule_batches
    from repro_torch.models import gnn as tgnn
    from repro_torch.models.common import tree_to

    bt = next(molecule_batches(shape["batch"], shape["n_nodes"],
                               shape["d_feat"], shape["n_classes"], seed=3))
    host = [torch.from_numpy(bt[k]) for k in ("feats", "adj")]
    args = [a.cuda() for a in host]
    params = tgnn.init_sage(cfg, shape["d_feat"], shape["n_classes"],
                            seed=2, device="cuda")
    got = tgnn.sage_molecule_forward(params, cfg, *args)
    want = tgnn.sage_molecule_forward(tree_to(params, "cpu"), cfg, *host)
    return {"graphs": shape["batch"],
            **near_cpu(torch, got, want, "molecule"),
            **step_times(torch, lambda: tgnn.sage_molecule_forward(
                params, cfg, *args))}


def csr_members(torch, row_ptr, col_idx, seeds, ids) -> bool:
    """True when every ids[b, j] is a CSR neighbour of seeds[b] (or the
    seed itself at zero degree): each pair looked up among the graph's
    sorted (src, dst) keys."""
    n = row_ptr.shape[0] - 1
    deg = (row_ptr[1:] - row_ptr[:-1]).long()
    src = torch.repeat_interleave(torch.arange(n, device=deg.device), deg)
    keys = torch.sort(src * n + col_idx.long()).values
    del src
    s = seeds.long()[:, None].expand_as(ids)
    pair = (s * n + ids.long()).reshape(-1)
    pos = torch.searchsorted(keys, pair).clamp_max(keys.shape[0] - 1)
    ok = (keys[pos] == pair).reshape(ids.shape) | (
        (deg[s] == 0) & (ids.long() == s))
    return bool(ok.all())


def sage_minibatch_lg(torch, cfg, shape, graph) -> dict:
    """minibatch_lg: the graph from ``build_sage_graph``, its CSR and
    features uploaded, ``sample_neighbors`` at fanouts 15 and 10 for 1,024
    seeds on the card (``gnn.sample_tree``: the sampler and the feature
    gather), ``sage_sampled_forward``: the ids CSR neighbours, the logits
    near the CPU's on the same ids; the step timed."""
    import numpy as np
    from repro_torch.models import gnn as tgnn
    from repro_torch.models.common import tree_to

    (proc,), d = graph
    t0 = time.perf_counter()
    proc.join()
    assert proc.exitcode == 0, f"graph build exited {proc.exitcode}"
    out = {"waited_s": time.perf_counter() - t0,
           **json.loads((d / "graph.json").read_text())}
    host = {k: np.load(d / f"{k}.npy")
            for k in ("row_ptr", "col_idx", "feats", "labels")}
    out.update(nodes=shape["n_nodes"], published_edges=shape["n_edges"],
               degree=SAGE_DEGREE)
    t0 = time.perf_counter()
    rp, ci, feats, labels = (torch.from_numpy(host[k]).cuda() for k in
                             ("row_ptr", "col_idx", "feats", "labels"))
    torch.cuda.synchronize()
    out["upload_s"] = time.perf_counter() - t0
    params = tgnn.init_sage(cfg, shape["d_feat"], shape["n_classes"],
                            seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, fan = shape["batch_nodes"], (shape["fanout1"], shape["fanout2"])
    seeds = torch.randint(0, shape["n_nodes"], (b,), generator=gen,
                          device="cuda", dtype=torch.int32)
    (n1, n2), xs = tgnn.sample_tree(gen, rp, ci, feats, seeds, fan)
    logits = tgnn.sage_sampled_forward(params, cfg, *xs)
    assert csr_members(torch, rp, ci, seeds, n1), "depth-1 ids"
    assert csr_members(torch, rp, ci, n1.reshape(-1), n2), "depth-2 ids"
    fc = torch.from_numpy(host["feats"])
    xc = (fc[seeds.cpu().long()],
          fc[n1.cpu().long().reshape(-1)].reshape(b, fan[0], -1),
          fc[n2.cpu().long().reshape(-1)].reshape(b, fan[0], fan[1], -1))
    want = tgnn.sage_sampled_forward(tree_to(params, "cpu"), cfg, *xc)
    out.update(near_cpu(torch, logits, want, "minibatch_lg"),
               ids_csr_neighbours=True)
    loss = tgnn.sampled_train_from_graph(params, cfg, rp, ci, feats, seeds,
                                         labels[seeds.long()], gen, fan)
    assert math.isfinite(loss.item())
    out["loss"] = loss.item()
    out["sample"] = step_times(torch, lambda: tgnn.sample_tree(
        gen, rp, ci, feats, seeds, fan))
    out["step"] = step_times(torch, lambda: tgnn.sage_sampled_forward(
        params, cfg, *tgnn.sample_tree(gen, rp, ci, feats, seeds, fan)[1]))
    return out


def phase_offpath(torch, graph) -> dict:
    """Phase 13: the recsys serve steps, retrieval_cand and GraphSAGE's
    three regimes at their published configs, one model resident at a
    time."""
    from repro_torch.configs import get_config

    assert not torch.backends.cuda.matmul.allow_tf32
    out = {}
    for arch in RECSYS_ARCHS:
        out[arch] = recsys_model(torch, arch)
        release(torch)
    conf = get_config("graphsage-reddit")
    cfg, shapes = conf.model, {s.name: s for s in conf.shapes}
    sage = {"full_graph_sm": sage_full_graph_sm(
                torch, cfg, shapes["full_graph_sm"]),
            "molecule": sage_molecule(torch, cfg, shapes["molecule"])}
    log("graphsage full_graph_sm, molecule " + json.dumps(sage))
    sage["minibatch_lg"] = sage_minibatch_lg(torch, cfg,
                                             shapes["minibatch_lg"], graph)
    log("graphsage minibatch_lg " + json.dumps(sage["minibatch_lg"]))
    out["graphsage-reddit"] = sage
    return out


# ---------------------------------------------------------------------------
# phase 14: training
# ---------------------------------------------------------------------------
def lm_step_flops(cfg, b: int, s: int) -> float:
    """Operations of one ``lm_loss`` train step at the shapes it computes:
    every product's forward, twice that in the backward, and the layers'
    forward once more under remat. Attention scores and values over the
    full S x S rectangle (one block at S 128); an MoE layer multiplies
    every expert's capacity buffer (E x C rows) and the router."""
    from repro_torch.models.moe import capacity

    D, H, KVH, Dh, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh,
                        cfg.vocab)
    t = b * s
    layer = 2 * t * (2 * D * H * Dh + 2 * D * KVH * Dh) + 4 * b * H * s * s * Dh
    if cfg.moe is None:
        layer += 2 * t * 3 * D * cfg.d_ff
    else:
        rows = cfg.moe.n_slots * capacity(t, cfg.moe)
        layer += 2 * rows * 3 * D * cfg.moe.d_ff + 2 * t * D * cfg.moe.n_slots
    fwd = cfg.n_layers * layer + 2 * t * D * V
    return 3 * fwd + (cfg.n_layers * layer if cfg.remat else 0)


def loss_and_gnorm(torch, model, tokens, labels, dtype=None):
    """-> (loss, global grad norm) of ``lm_loss`` on ``model``."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import tree_tensors
    from repro_torch.utils import tree_norm

    leaves = tree_tensors(model.requires_grad_(True))
    loss = tf.lm_loss(model, tokens, labels, dtype=dtype)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), tree_norm(list(grads)).item()


def cpu_twin(torch, model):
    """The model's weights copied into a CPU ``LM``."""
    from repro_torch.models import transformer as tf

    twin = tf.LM(model.cfg, device="cpu", dtype=model.dtype)
    twin.load_state_dict(model.state_dict())
    return twin


def capture_routes(torch):
    """Patch ``moe.route`` to record each call's (probs, ids) on the CPU
    -> (the list they go to, a function that restores it)."""
    from repro_torch.models import moe as tmoe

    calls, route = [], tmoe.route

    def recording(p, cfg, x):
        out = route(p, cfg, x)
        calls.append((out[0].detach().cpu(), out[2].cpu()))
        return out

    tmoe.route = recording

    def restore():
        tmoe.route = route
    return calls, restore


def routes_agree(torch, card, cpu, k: int) -> dict:
    """Each layer's router ids, card against CPU, where the k-th
    probability clears the (k+1)-th by 1e-5 (>= 99 % of tokens)."""
    ok_all, equal = [], True
    for (_, ids_d), (probs, ids) in zip(card, cpu):
        top = torch.sort(probs, dim=-1, descending=True).values
        ok = (top[:, k - 1] - top[:, k]) > 1e-5
        ok_all.append(ok.float().mean().item())
        equal &= bool(torch.equal(ids_d[ok], ids[ok]))
    assert min(ok_all) >= 0.99, f"tokens clear of ties: {ok_all}"
    assert equal, "routing differs from the CPU's"
    return {"layers": len(card), "clear_of_ties": ok_all, "ids_equal": True}


def state_snapshot(torch, model, state) -> dict:
    """Copies of the weights, m and v."""
    from repro_torch.models.common import named_tensors

    return {"p": {n: p.detach().clone() for n, p in named_tensors(model)},
            "m": {n: t.clone() for n, t in state.m.items()},
            "v": {n: t.clone() for n, t in state.v.items()}}


def restore_fresh(torch, model, state, weights: dict) -> None:
    """Back to the start of training: ``weights``, zero m, v and step."""
    from repro_torch.models.common import named_tensors

    with torch.no_grad():
        for n, p in named_tensors(model):
            p.copy_(weights[n])
        for t in itertools.chain(state.m.values(), state.v.values(),
                                 (state.step,)):
            t.zero_()


def unequal_leaves(torch, model, state, snap) -> dict:
    """Leaves whose weights, m or v differ in any bit from ``snap``."""
    from repro_torch.models.common import named_tensors

    out = {"p": [n for n, p in named_tensors(model)
                 if not torch.equal(p.detach(), snap["p"][n])]}
    for key in ("m", "v"):
        out[key] = [n for n, t in getattr(state, key).items()
                    if not torch.equal(t, snap[key][n])]
    return out


def train_lm_cell(torch, arch: str) -> dict:
    """(a) / (b) One LM at its published width, 2 layers, fp32 weights
    from a seeded CUDA generator, ``launch.train``'s optimizer:
    the B 1 loss and grad norm card against CPU (1e-4 relative); (b) the
    router ids of the first step against a CPU forward; (d) the first
    step twice from one state; then five steps, each with its loss, wall
    ms, peak GB and zero hand-kernel launches, the device ms a step
    (queued), tokens/s and TFLOP/s against the fp32 bound; (c) for the
    dense LM, one bf16 ``lm_loss`` step at B 1 against the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import count_params, named_tensors
    from repro_torch.train.optimizer import AdamWConfig, warmup_cosine
    from repro_torch.train.train_loop import init_train_state, make_train_step

    cfg = dataclasses.replace(get_config(arch).model, n_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    model = tf.init_lm(cfg, seed=0, device="cuda")
    state = init_train_state(model)
    torch.cuda.synchronize()
    n = count_params(model)
    out = {"layers": cfg.n_layers, "params": n, "init_s":
           time.perf_counter() - t0,
           "state_gb": 16 * n / 1e9, "B": TRAIN_B, "S": TRAIN_S}
    data = lm_batches(cfg.vocab, TRAIN_B, TRAIN_S + 1, seed=0)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in next(data).items()}
               for _ in range(TRAIN_STEPS + 1)]
    row = {k: v[:1] for k, v in batches[0].items()}

    # B 1 loss and grad norm, card against CPU (and (c) at bf16)
    t0 = time.perf_counter()
    twin = cpu_twin(torch, model)
    rows = {k: v.cpu() for k, v in row.items()}
    cells = {"fp32": None, "bf16": torch.bfloat16} if cfg.moe is None \
        else {"fp32": None}
    for name, dt in cells.items():
        card = loss_and_gnorm(torch, model, row["tokens"], row["labels"], dt)
        cpu = loss_and_gnorm(torch, twin, rows["tokens"], rows["labels"], dt)
        gaps = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
        rec = {"loss": card[0], "cpu_loss": cpu[0], "grad_norm": card[1],
               "cpu_grad_norm": cpu[1], "loss_rel_gap": gaps[0],
               "grad_norm_rel_gap": gaps[1]}
        if dt is None:
            assert max(gaps) <= 1e-4, f"{arch} B 1 card vs CPU: {rec}"
        else:
            assert gaps[0] <= BF16_LOSS_RTOL and gaps[1] <= BF16_GNORM_RTOL, \
                f"{arch} bf16 B 1 card vs CPU: {rec}"
            rec["tolerance"] = {"loss": BF16_LOSS_RTOL,
                                "grad_norm": BF16_GNORM_RTOL}
            rec["gap_to_fp32_loss"] = abs(card[0] - out["b1"]["loss"])
        out["b1" if dt is None else "bf16_b1"] = rec
    out["cpu_s"] = time.perf_counter() - t0

    opt = AdamWConfig(lr=warmup_cosine(3e-4, 5, 100))
    step = make_train_step(lambda p, tokens, labels: tf.lm_loss(
        p, tokens, labels, dtype=torch.float32), opt)
    flops = lm_step_flops(cfg, TRAIN_B, TRAIN_S)
    bound_s = flops / FP32_FLOPS_PER_S
    weights = {n: p.detach().clone() for n, p in named_tensors(model)}
    routes = restore = None
    if cfg.moe is not None:
        routes, restore = capture_routes(torch)
    steps, repeat = [], None
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        _, state, metrics = step(model, state, batches[i])
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dispatch.snapshot()
        launched = {k: v for k, v in counts.items()
                    if k.startswith("kernel.") and v}
        assert not launched, f"{arch} step {i} launched {launched}"
        loss = metrics["loss"].item()
        assert math.isfinite(loss), f"{arch} step {i}: loss {loss}"
        steps.append({"loss": loss, "grad_norm": metrics["grad_norm"].item(),
                      "lr": metrics["lr"].item(), "wall_ms": wall * 1e3,
                      "event_ms": start.elapsed_time(end),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "tokens_per_s": TRAIN_B * TRAIN_S / wall,
                      "tflops_wall": flops / wall / 1e12})
        if i == 0:
            if restore is not None:
                restore()
                out["routing"] = first_step_routes(
                    torch, twin, batches[0], routes[:cfg.n_layers],
                    cfg.moe.top_k)
            out["counters"] = counts
            repeat, state = repeat_first_step(
                torch, step, model, state, batches[0], weights, metrics, arch)
            del weights
    del twin
    device_ms = queued_ms(torch, lambda: step(model, state, batches[
        TRAIN_STEPS]), 2)
    walls = [st["wall_ms"] for st in steps[1:]]
    out.update(
        steps=steps, repeat=repeat, flops=flops, bound_ms=bound_s * 1e3,
        bound_by="operations (fp32, 67 TFLOP/s)", device_ms=device_ms,
        tflops_device=flops / device_ms / 1e9,
        bound_share_device=bound_s * 1e3 / device_ms,
        median_wall_ms=statistics.median(walls),
        idle_share=1.0 - device_ms / statistics.median(walls),
        first_loss=steps[0]["loss"], last_loss=steps[-1]["loss"])
    return out


def first_step_routes(torch, twin, batch, card_routes, k: int) -> dict:
    """(b) The first step's router ids (recorded on the card) against a
    CPU forward of the same batch and weights."""
    from repro_torch.models import transformer as tf

    calls, restore = capture_routes(torch)
    try:
        with torch.no_grad():
            tf.forward_hidden(twin, batch["tokens"].cpu())
    finally:
        restore()
    return routes_agree(torch, card_routes, calls, k)


def repeat_first_step(torch, step, params, state, batch, weights: dict,
                      first: dict, what: str) -> tuple[dict, object]:
    """(d) ``first`` (the metrics of ``step`` from the fresh state whose
    weights are ``weights``) against the same step again from that
    state: the loss, grad norm, weights, m and v compared bit for bit
    (the leaves that differ named; they must stay within 1e-5) -> (the
    record, the optimizer state after the repeated step)."""
    from repro_torch.models.common import named_tensors

    after = state_snapshot(torch, params, state)
    restore_fresh(torch, params, state, weights)
    _, state, again = step(params, state, batch)
    diff = unequal_leaves(torch, params, state, after)
    rec = {k: again[k].item() == first[k].item()
           for k in ("loss", "grad_norm")}
    rec = {"loss_equal": rec["loss"], "grad_norm_equal": rec["grad_norm"],
           "unequal_weights": diff["p"], "unequal_m (grads)": diff["m"],
           "unequal_v": diff["v"]}
    rec["bit_for_bit"] = (rec["loss_equal"] and rec["grad_norm_equal"]
                          and not any(diff.values()))
    if not rec["bit_for_bit"]:
        rec["max_weight_gap"] = max(
            float((p.detach() - after["p"][n]).abs().max())
            for n, p in named_tensors(params))
        assert rec["max_weight_gap"] <= 1e-5, f"{what}: {rec}"
    log(f"{what} repeated first step " + json.dumps(rec))
    return rec, state


def repeat_step(torch, arch: str, preset: str, batch: int) -> dict:
    """(d) ``launch.train.build``'s model and loss on the card, its first
    step twice from the same fresh state (``repeat_first_step``)."""
    import argparse
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.common import named_tensors
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import init_train_state, make_train_step

    args = argparse.Namespace(seed=0, batch=batch, seq=TRAIN_S,
                              device="cuda")
    _, params, loss_fn, data = tlaunch.build(arch, preset, args)
    step, state, b = make_train_step(loss_fn, AdamWConfig()), \
        init_train_state(params), next(data)
    weights = {n: p.detach().clone() for n, p in named_tensors(params)}
    _, state, first = step(params, state, b)
    rec, _ = repeat_first_step(torch, step, params, state, b, weights,
                               first, f"{arch} {preset}")
    return {"B": batch, **rec}


def train_launch_runs(torch) -> dict:
    """(e) ``launch.train.main`` on the card: llama3-8b small for 30 steps
    (the last loss below the first), each other family's smoke preset
    for 5 steps and fm and wide-deep at their published tables (the
    small preset) for 3; finite losses, step ms and peak GB."""
    from repro_torch.launch import train as tlaunch

    out = {}
    for arch, preset, n in TRAIN_RUNS:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = tlaunch.main(["--arch", arch, "--preset", preset, "--steps",
                            str(n)])
        losses = [h["loss"] for h in res["history"]]
        assert len(losses) == n and all(map(math.isfinite, losses)), \
            f"{arch} {preset}: {losses}"
        rec = {"params": res["params"], "steps": n, "first_loss": losses[0],
               "last_loss": losses[-1],
               "step_ms": statistics.median(
                   h["sec"] for h in res["history"][1:]) * 1e3,
               "first_step_ms": res["history"][0]["sec"] * 1e3,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "run_s": time.perf_counter() - t0}
        if preset == "small" and arch == "llama3-8b":
            assert losses[-1] < losses[0], f"{arch} small: {losses}"
        out[f"{arch} {preset}"] = rec
        log(f"launch.train {arch} {preset} " + json.dumps(rec))
        del res
        release(torch)
    return out


def phase_train(torch) -> dict:
    """Phase 14: training on the card, one model resident at a time."""
    assert not torch.backends.cuda.matmul.allow_tf32
    out = {}
    for arch in TRAIN_LMS:
        out[arch] = train_lm_cell(torch, arch)
        log(f"{arch} train " + json.dumps(out[arch]))
        release(torch)
    for arch, preset, batch in REPEAT_RUNS:
        out[f"repeat {arch} {preset}"] = repeat_step(torch, arch, preset,
                                                     batch)
        release(torch)
    out["launch"] = train_launch_runs(torch)
    return out


# ---------------------------------------------------------------------------
# phase 15: checkpoints, fault tolerance and the distributed training layer
# ---------------------------------------------------------------------------
def lm_config(arch: str, **replace):
    """A published LM config (``configs/``), fields replaced."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch).model, **replace)


def state_bytes(torch, tree) -> int:
    from repro_torch.train.checkpoint import tree_leaves

    return sum(t.numel() * t.element_size() for _, t in tree_leaves(tree))


def unequal(torch, a, b) -> list[str]:
    """The leaves of two trees of one structure that differ in any bit."""
    from repro_torch.train.checkpoint import tree_leaves

    want = dict(tree_leaves(b))
    return [k for k, t in tree_leaves(a)
            if not torch.equal(t.detach(), want[k].detach())]


def logged_ckpt(directory, **kw):
    """A ``CheckpointManager`` that keeps each save's step and stall."""
    from repro_torch.train.checkpoint import CheckpointManager

    class Logged(CheckpointManager):
        def save(self, step, state, meta=None):
            path = super().save(step, state, meta)
            self.stalls.append({"step": step, "stall_ms":
                                self.last_save["stall_s"] * 1e3})
            return path

    mgr = Logged(str(directory), **kw)
    mgr.stalls = []
    return mgr


def ckpt_save_full(torch) -> dict:
    """(a), first half: llama3-8b at its published width, 2 layers, one
    ``make_train_step`` step (m and v hold its moments), then one async
    save of {params, opt}: the caller's stall."""
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import AdamWConfig, warmup_cosine
    from repro_torch.train.train_loop import init_train_state, make_train_step

    cfg = lm_config("llama3-8b", n_layers=TRAIN_LAYERS)
    model = tf.init_lm(cfg, seed=0, device="cuda")
    state = init_train_state(model)
    step = make_train_step(lambda p, tokens, labels: tf.lm_loss(
        p, tokens, labels, dtype=torch.float32),
        AdamWConfig(lr=warmup_cosine(3e-4, 5, 100)))
    data = lm_batches(cfg.vocab, TRAIN_B, TRAIN_S + 1, seed=0)
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in next(data).items()}
               for _ in range(2)]
    _, state, _ = step(model, state, batches[0])
    torch.cuda.synchronize()
    d = store_dir("ckpt_full")
    ckpt = logged_ckpt(d, keep=1, async_save=True)
    live = {"params": model, "opt": state}
    t0 = time.perf_counter()
    ckpt.save(1, live)
    stall = time.perf_counter() - t0
    rec = {"layers": cfg.n_layers, "state_bytes": state_bytes(torch, live),
           "stall_s": stall}
    rec["stall_gb_per_s"] = rec["state_bytes"] / stall / 1e9
    log("checkpoint (a) async save of llama3-8b's state: " + json.dumps(rec))
    return {"rec": rec, "live": live, "step": step, "batch": batches[1],
            "ckpt": ckpt, "dir": d, "t_save": time.perf_counter()}


def ckpt_restore_full(torch, saved: dict) -> dict:
    """(a), second half: the write's seconds, GB/s and bytes; the restore
    onto the card (seconds, GB/s, peak GB); every leaf and one step from
    the restored state bit for bit the live state's."""
    from repro_torch.core import dispatch

    rec, ckpt, live = saved["rec"], saved["ckpt"], saved["live"]
    t0 = time.perf_counter()
    ckpt.wait()
    rec["waited_s"] = time.perf_counter() - t0
    rec["write_overlapped_s"] = t0 - saved["t_save"]
    rec["write_s"] = ckpt.last_save["write_s"]
    rec["file_bytes"] = ckpt.last_save["bytes"]
    rec["write_gb_per_s"] = rec["file_bytes"] / rec["write_s"] / 1e9
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    got, meta = ckpt.restore(live)
    torch.cuda.synchronize()
    rec["restore_s"] = time.perf_counter() - t0
    rec["restore_gb_per_s"] = rec["file_bytes"] / rec["restore_s"] / 1e9
    rec["restore_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["allocated_before_restore_gb"] = base
    rec["read"] = "warm (the file was just written; page cache not dropped)"
    assert meta == {"step": 1}, meta
    bad = unequal(torch, got, live)
    assert not bad, f"restored leaves differ: {bad[:5]}"
    rec["leaves_bit_for_bit"] = True
    step, batch = saved["step"], saved["batch"]
    dispatch.reset()
    _, s_live, m_live = step(live["params"], live["opt"], batch)
    _, s_got, m_got = step(got["params"], got["opt"], batch)
    launched = {k: v for k, v in dispatch.snapshot().items()
                if k.startswith("kernel.") and v}
    assert not launched, f"a train step launched {launched}"
    for k in ("loss", "grad_norm"):
        assert torch.equal(m_live[k], m_got[k]), (k, m_live[k], m_got[k])
    bad = unequal(torch, {"params": got["params"], "opt": s_got},
                  {"params": live["params"], "opt": s_live})
    assert not bad, f"the step from the restored state differs: {bad[:5]}"
    rec.update(step_loss=m_got["loss"].item(), step_bit_for_bit=True)
    shutil.rmtree(saved["dir"], ignore_errors=True)
    log("checkpoint (a) restore " + json.dumps(rec))
    return rec


def ft_example(torch) -> tuple[dict, dict]:
    """(b) ``examples/torch_fault_tolerant_training.py``'s supervised run
    on the card, at ``launch.train``'s small llama3-8b -> (record, the
    failure-free run's final state)."""
    from repro_torch.launch.train import small_lm
    from repro_torch.models import transformer as tf
    from repro_torch.train.checkpoint import tree_leaves
    from repro_torch.train.fault_tolerance import StragglerWatchdog

    ex = load_example("torch_fault_tolerant_training")
    cfg = small_lm(lm_config("llama3-8b"))
    model = tf.init_lm(cfg, seed=0, device="cuda")
    out, finals = {}, {}
    for name, fails, async_save, wd in (
            ("two failures", ex.FAIL_AT, True,
             StragglerWatchdog(min_samples=5, factor=4.0)),
            ("failure-free", (), False, None),
            ("failure at 3", (FT_SCRATCH_FAIL,), True, None)):
        d = store_dir("ft")
        ckpt = logged_ckpt(d, keep=3, async_save=async_save)
        t0 = time.perf_counter()
        params, state, info = ex.resilient_run(model, cfg, ckpt,
                                               fail_at=fails, watchdog=wd)
        ckpt.wait()
        wall = time.perf_counter() - t0
        shutil.rmtree(d, ignore_errors=True)
        finals[name] = {"params": params, "opt": state}
        out[name] = {"restarts": info["restarts"], "wall_s": wall,
                     "final_loss": info["losses"][ex.STEPS - 1],
                     "losses": info["losses"], "saves": ckpt.stalls,
                     "stragglers": [dataclasses.asdict(e)
                                    for e in info["stragglers"]]}
    clean = out["failure-free"]
    assert [out[k]["restarts"] for k in out] == [2, 0, 1], out
    for name in ("two failures", "failure at 3"):
        assert out[name]["losses"] == clean["losses"], \
            f"{name}: losses differ from the failure-free run"
        bad = unequal(torch, finals[name], finals["failure-free"])
        assert not bad, f"{name}: final state differs: {bad[:5]}"
        out[name]["bit_for_bit"] = True
    for rec in out.values():
        rec["losses"] = [rec["losses"][s] for s in range(ex.STEPS)]
    out["params"] = sum(t.numel() for _, t in tree_leaves(model))
    log("checkpoint (b) fault-tolerant example " + json.dumps(out))
    return out, {"cfg": cfg, "steps": ex.STEPS, **finals["failure-free"]}


def ckpt_launch_train(torch) -> dict:
    """(c) ``launch.train.main --ckpt-dir``: the small llama3-8b for 20
    steps (a checkpoint every 10), then the same command for 30, which
    resumes at step 20."""
    from repro_torch.launch import train as tlaunch

    d = store_dir("launch_ckpt")
    out = {}
    try:
        for steps in CKPT_STEPS:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated() / 1e9
            t0 = time.perf_counter()
            res = tlaunch.main(
                ["--arch", "llama3-8b", "--preset", "small", "--steps",
                 str(steps), "--ckpt-every", str(CKPT_EVERY), "--ckpt-dir",
                 str(d), "--device", "cuda"])
            hist = res["history"]
            out[f"--steps {steps}"] = {
                "start_step": res["start_step"], "steps_run": len(hist),
                "first_step": hist[0]["step"], "first_loss": hist[0]["loss"],
                "last_loss": hist[-1]["loss"],
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "allocated_before_gb": base,
                "run_s": time.perf_counter() - t0,
                "on_disk": sorted(p.name for p in d.glob("step_*"))}
        first, second = (out[f"--steps {n}"] for n in CKPT_STEPS)
        assert first["start_step"] == 0 and first["steps_run"] == 20
        assert second["start_step"] == 20 and second["first_step"] == 20 \
            and second["steps_run"] == 10, second
        assert math.isfinite(second["first_loss"])
        assert second["on_disk"] == ["step_00000010.npz", "step_00000020.npz",
                                     "step_00000030.npz"], second
    finally:
        shutil.rmtree(d, ignore_errors=True)
    log("checkpoint (c) launch.train --ckpt-dir " + json.dumps(out))
    return out


def pipeline_cell(torch) -> dict:
    """(d) four full-width llama3-8b layers as four pipeline stages, 8
    microbatches of 1 x 128 tokens: output and gradients against the
    sequential oracle, the ticks, the bubble and the ms."""
    from repro_torch.distributed.pipeline import (pipeline_apply,
                                                  pipeline_bubble_fraction,
                                                  pipeline_schedule,
                                                  stage_devices)
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.models import transformer as tf

    cfg = lm_config("llama3-8b", n_layers=PIPE_STAGES)
    model = tf.init_lm(cfg, seed=1, device="cuda")
    stacked = tf.stack_layers(model)
    del model
    release(torch)
    stage = tf.layer_stage(cfg)
    mesh = Mesh((PIPE_STAGES,), ("pp",))
    devs = stage_devices(mesh, "pp")
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(PIPE_MICRO, PIPE_MB, PIPE_S, cfg.d_model, device="cuda",
                    generator=gen)

    def sequential(p, x):
        ps = [{k: v[s] for k, v in p.items()} for s in range(PIPE_STAGES)]
        out = []
        for m in range(x.shape[0]):
            h = x[m]
            for s in range(PIPE_STAGES):
                h = stage(ps[s], h)
            out.append(h)
        return torch.stack(out)

    def run(fn):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in stacked.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(leaves, x)
        grads = torch.autograd.grad(out.sum(), list(leaves.values()))
        torch.cuda.synchronize()
        return out.detach(), grads, (time.perf_counter() - t0) * 1e3

    pipe = lambda p, x: pipeline_apply(mesh, "pp", stage, p, x)
    run(pipe)                                       # warm-up
    want = run(sequential)
    got = run(pipe)
    same_card = len(set(devs)) == 1
    pairs = [(got[0], want[0])] + list(zip(got[1], want[1]))
    if same_card:
        assert all(torch.equal(a, b) for a, b in pairs), \
            "pipeline != sequential oracle on one card"
        err = 0.0
    else:
        err = max(float((a - b).abs().max()) for a, b in pairs)
        assert all(torch.allclose(a, b, rtol=1e-5, atol=1e-5)
                   for a, b in pairs), f"pipeline vs oracle {err}"
    rec = {"stages": PIPE_STAGES, "micro": PIPE_MICRO,
           "micro_shape": [PIPE_MB, PIPE_S, cfg.d_model],
           "devices": [str(d) for d in devs],
           "ticks": len(pipeline_schedule(PIPE_STAGES, PIPE_MICRO)),
           "bubble_fraction": pipeline_bubble_fraction(PIPE_STAGES,
                                                       PIPE_MICRO),
           "bit_for_bit": same_card, "max_abs_err": err,
           "pipeline_fwd_bwd_ms": got[2], "sequential_fwd_bwd_ms": want[2],
           "stage_params": sum(v[0].numel() for v in stacked.values())}
    assert rec["ticks"] == PIPE_MICRO + PIPE_STAGES - 1
    log("checkpoint (d) pipeline " + json.dumps(rec))
    return rec


def compressed_psum_cell(torch) -> dict:
    """(e) ``compressed_psum`` over 4 replicas of a seeded fp32 tensor of
    the llama3-8b embedding gradient's shape, on the mesh's devices."""
    from repro_torch.distributed.collectives import compressed_psum
    from repro_torch.distributed.sharding import Mesh

    cfg = lm_config("llama3-8b")
    shape = (cfg.vocab, cfg.d_model)
    mesh = Mesh((PSUM_REPLICAS,), ("data",))
    devs = list(mesh.devices.flat)
    parts = [torch.randn(shape, device=d, generator=torch.Generator(
        device=d).manual_seed(10 + r)) for r, d in enumerate(devs)]
    exact = parts[0].clone()
    for p in parts[1:]:
        exact += p.to(devs[0])
    compressed_psum(parts)                          # warm-up
    for d in set(devs):
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    out = compressed_psum(parts)
    for d in set(devs):
        torch.cuda.synchronize(d)
    ms = (time.perf_counter() - t0) * 1e3
    rel = float((out[0] - exact).abs().max() / exact.abs().max())
    assert rel < PSUM_BOUND, f"compressed_psum: {rel} of the exact sum"
    assert all(torch.equal(o.to(devs[0]), out[0]) for o in out), \
        "replicas differ"
    n, s = exact.numel(), PSUM_REPLICAS
    rec = {"replicas": s, "shape": list(shape),
           "devices": [str(d) for d in devs], "max_rel_err": rel,
           "bound": PSUM_BOUND, "replicas_equal": True, "ms": ms,
           # reduce-scatter + all-gather of the int8 chunks, their fp32
           # scales; an fp32 ring all-reduce moves 2 (S - 1) n 4 bytes
           "int8_bytes_moved": 2 * (s - 1) * n + 4 * (s - 1) * (s + 1),
           "fp32_ring_bytes": 2 * (s - 1) * n * 4}
    rec["bytes_ratio"] = rec["fp32_ring_bytes"] / rec["int8_bytes_moved"]
    log("checkpoint (e) compressed_psum " + json.dumps(rec))
    return rec


def restore_sharded_cell(torch, final: dict) -> dict:
    """(f) (b)'s final state placed on a (4, 2) mesh, saved, restored onto
    (2, 4): each block of ``spec_for``'s shape, the blocks joined equal to
    the saved leaves."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as tf
    from repro_torch.train.checkpoint import tree_leaves
    from repro_torch.train.optimizer import OptState, opt_state_axes

    mesh_a, mesh_b = (sh.Mesh(m, ("data", "model"))
                      for m in (MESH_SAVE, MESH_RESTORE))
    p_axes = tf.lm_param_axes(final["cfg"])
    axes = {"params": p_axes, "opt": opt_state_axes(p_axes)}
    params, opt = final["params"], final["opt"]
    with sh.axis_rules(mesh_a):
        def put(t, ax):
            return sh.device_put(t.detach(), sh.named_sharding(t.shape, *ax))
        placed = {"params": {n: put(p, p_axes[n])
                             for n, p in params.named_parameters()},
                  "opt": OptState(
                      {n: put(t, axes["opt"].m[n]) for n, t in opt.m.items()},
                      {n: put(t, axes["opt"].v[n]) for n, t in opt.v.items()},
                      put(opt.step, ()))}
    d = store_dir("sharded")
    try:
        ckpt = logged_ckpt(d)
        ckpt.save(final["steps"], placed)
        t0 = time.perf_counter()
        got, _ = ckpt.restore_sharded({"params": params, "opt": opt}, axes,
                                      mesh_b)
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    saved = dict(tree_leaves({"params": params, "opt": opt}))
    split, leaves = 0, 0
    with sh.axis_rules(mesh_b):
        for key, arr in tree_leaves(got):
            spec = arr.sharding.spec
            assert spec == sh.spec_for(arr.shape, ax_of(axes, key)), key
            block = [dim // math.prod(mesh_b.shape[a] for a in (
                () if e is None else (e,) if isinstance(e, str) else e))
                for dim, e in zip(arr.shape, spec + (None,) * (
                    len(arr.shape) - len(spec)))]
            assert len(arr.addressable_shards) == math.prod(MESH_RESTORE)
            assert all(list(s.data.shape) == block
                       for s in arr.addressable_shards), (key, block)
            assert torch.equal(arr.gather(), saved[key].detach()), key
            split += list(block) != list(arr.shape)
            leaves += 1
    rec = {"save_mesh": MESH_SAVE, "restore_mesh": MESH_RESTORE,
           "leaves": leaves, "leaves_split": split,
           "blocks_a_leaf": math.prod(MESH_RESTORE), "restore_s": restore_s,
           "blocks_joined_equal": True}
    log("checkpoint (f) restore_sharded " + json.dumps(rec))
    return rec


def ax_of(axes: dict, key: str) -> tuple:
    """A leaf's logical axes by its checkpoint key."""
    top, rest = key.split("/", 1)
    if top == "params":
        return axes["params"][rest]
    field, _, name = rest.partition("/")
    return axes["opt"].step if field == "step" else \
        getattr(axes["opt"], field)[name]


def phase_ckpt(torch) -> dict:
    """Phase 15: (a)'s async save overlaps (b) to (f); then (a)'s
    restore."""
    out, seconds = {}, {}
    t = time.perf_counter()
    saved = ckpt_save_full(torch)
    seconds["a save"] = time.perf_counter() - t
    final = None
    for name, fn in (("b fault tolerance", ft_example),
                     ("c launch.train --ckpt-dir", ckpt_launch_train),
                     ("d pipeline", pipeline_cell),
                     ("e compressed_psum", compressed_psum_cell)):
        t = time.perf_counter()
        res = fn(torch)
        if name.startswith("b"):
            res, final = res
        out[name] = res
        seconds[name] = time.perf_counter() - t
        release(torch)
    t = time.perf_counter()
    out["f restore_sharded"] = restore_sharded_cell(torch, final)
    seconds["f restore_sharded"] = time.perf_counter() - t
    del final
    release(torch)
    t = time.perf_counter()
    out["a checkpoint"] = ckpt_restore_full(torch, saved)
    seconds["a restore"] = time.perf_counter() - t
    del saved
    out["seconds"] = seconds
    log("phase 15 seconds " + json.dumps(seconds))
    return out


# ---------------------------------------------------------------------------
# phase 16: the dry-run tooling on the card
# ---------------------------------------------------------------------------
def dryrun_rows() -> list[dict]:
    """(a) ``launch.dryrun``'s CLI on ``DRY_CELLS`` (pod mesh, published
    configs, baseline, on meta): every row ok, no hand kernel uncosted."""
    from repro_torch.launch import dryrun

    d = store_dir("dryrun")
    try:
        argv = ["--mesh", "pod", "--out", str(d / "dryrun.json")]
        for arch in dict.fromkeys(a for a, _, _, _ in DRY_CELLS):
            argv += ["--arch", arch]
        for shape in dict.fromkeys(sh for _, sh, _, _ in DRY_CELLS):
            argv += ["--shape", shape]
        assert dryrun.main(argv) == 0, "launch.dryrun failed a cell"
        rows = json.loads((d / "dryrun.json").read_text())
    finally:
        shutil.rmtree(d, ignore_errors=True)
    assert sorted((r["arch"], r["shape"]) for r in rows) == sorted(
        (a, sh) for a, sh, _, _ in DRY_CELLS), rows
    for r in rows:
        assert r["status"] == "ok" and r["uncosted"] == {}, r
        log("dryrun (a) " + json.dumps({k: r[k] for k in (
            "arch", "shape", "mesh", "count_s", "op_flops_per_dev",
            "op_bytes_per_dev", "model_bytes_per_dev", "t_compute_s",
            "t_memory_s", "t_memory_ops_s", "t_collective_s", "bottleneck",
            "roofline_fraction", "useful_ratio", "total_bytes_per_dev",
            "fits_hbm", "kernels")}))
    return rows


def dryrun_card_cell(torch, arch: str, shape: str, layers, reps: int,
                     smi: str) -> tuple[dict, dict]:
    """(b) One cell on the card at its published widths (depth cut to
    ``layers``) on a one-card host mesh: counted once under
    ``op_analysis`` (FLOPs and bytes equal to the same cell's count on
    meta; no hand kernel uncosted; the launch counters zeroed just before
    and read just after), then timed without the counter (CUDA events
    over ``reps`` steps after a warm-up) beside its bound, the larger of
    the counted operations over the card's peaks and the counted bytes
    over its HBM rate. -> (record, launch counters)."""
    from repro_torch.core import dispatch
    from repro_torch.launch import dryrun, op_analysis, steps
    from repro_torch.launch.mesh import make_host_mesh

    meta = dryrun.count_cell(arch, shape, make_host_mesh(1, 1, device="meta"),
                             n_layers=layers)
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cell = steps.make_cell(arch, shape, make_host_mesh(1, 1), device="cuda",
                           n_layers=layers)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    dispatch.reset()
    card = op_analysis.analyze(cell.fn, *cell.args)
    torch.cuda.synchronize()
    counts = dispatch.snapshot()
    out = card.pop("out")
    for key in ("flops", "flops_by_dtype", "bytes", "kernels"):
        assert card[key] == meta[key], (arch, shape, key, card[key],
                                        meta[key])
    assert card["uncosted"] == {} and meta["uncosted"] == {}, (card, meta)
    vals = [out[0]] if isinstance(out, tuple) else [out]
    assert all(bool(torch.isfinite(v.float()).all()) for v in vals), \
        f"{arch} {shape}: non-finite output"
    del out, vals
    ms = time_ms(torch, lambda: cell.fn(*cell.args), reps, warmup=1)
    compute_ms = dryrun.compute_seconds(card["flops_by_dtype"]) * 1e3
    memory_ms = card["bytes"] / dryrun.HBM_BW * 1e3
    bound_ms = max(compute_ms, memory_ms)
    rec = {"arch": arch, "shape": shape, "layers": layers, "ms": ms,
           "bound_ms": bound_ms,
           "bound_by": "bytes" if memory_ms >= compute_ms else "operations",
           "share_of_bound": bound_ms / ms, "compute_ms": compute_ms,
           "memory_ops_ms": memory_ms, "flops": card["flops"],
           "flops_by_dtype": card["flops_by_dtype"], "bytes": card["bytes"],
           "kernels": card["kernels"],
           "input_gb": steps.arg_bytes(cell) / 1e9, "build_s": build_s,
           "count_s_meta": meta["count_s"],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi}
    assert ms >= DRY_MIN_SHARE_OF_BOUND * bound_ms, \
        f"{arch} {shape}: {ms:.4f} ms under its bound {bound_ms:.4f} ms"
    log("dryrun (b) " + json.dumps(rec))
    return rec, counts


def phase_dryrun(torch, smi: str) -> dict:
    """Phase 16: (a) the dry run's rows; (b) each cell on the card:
    llama3-8b decode launches flash_decode's bf16 instance once a layer,
    the retrieval cells distance_topk once a search."""
    out, seconds = {"counters": {}}, {}
    t = time.perf_counter()
    out["rows"] = dryrun_rows()
    seconds["a dryrun"] = time.perf_counter() - t
    for arch, shape, layers, reps in DRY_CELLS:
        t = time.perf_counter()
        rec, counts = dryrun_card_cell(torch, arch, shape, layers, reps, smi)
        if arch == "llama3-8b":
            assert counts.get("kernel.flash_decode.bf16", 0) == layers, counts
        if arch == "mememo":
            assert counts.get("kernel.distance_topk", 0) == 1, counts
        out[f"{arch} {shape}"] = rec
        out["counters"][f"{arch} {shape} cell"] = counts
        seconds[f"b {arch} {shape}"] = time.perf_counter() - t
        release(torch)
    out["seconds"] = seconds
    log("phase 16 seconds " + json.dumps(seconds))
    return out


# ---------------------------------------------------------------------------
# phase 17: the examples and the legacy builder
# ---------------------------------------------------------------------------
def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def legacy_int_rows():
    """(a)'s rows: phase 5 (a)'s size, integer-valued (exact in fp32)."""
    import numpy as np

    return np.random.default_rng(17).integers(
        -3, 4, size=(BULK_INT["rows"], BULK_INT["dim"])).astype(np.float32)


def legacy_int_kw() -> dict:
    return dict(M=BULK_INT["M"], ef_construction=BULK_INT["ef_construction"],
                batch_size=BULK_INT["batch_size"], metric="l2", seed=0)


def build_legacy_int(out_dir: str, device: str) -> None:
    """(a)'s build on ``device`` in a process of its own (started before
    phase 14, so that its host loops overlap phases 14 to 16; on the card
    it launches 10 searches): ``bulk_build_legacy``'s graph saved under
    ``out_dir``, with the build's seconds and launch counters."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import dispatch
    from repro_torch.core import hnsw_build as tb

    dispatch.reset()
    t0 = time.perf_counter()
    g = tb.bulk_build_legacy(legacy_int_rows(), device=device,
                             **legacy_int_kw())
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    np.savez(Path(out_dir) / f"{device}.npz", neighbors0=g.neighbors0,
             upper=g.upper, levels=g.levels, vectors=g.vectors,
             entry=g.entry, max_level=g.max_level)
    (Path(out_dir) / f"{device}.json").write_text(json.dumps(
        {"seconds": secs, "counts": dispatch.snapshot()}))


def legacy_bit_identical(torch, builds) -> dict:
    """(a) ``bulk_build_legacy``'s card graph against the CPU's on
    integer-valued l2 rows: every array bit for bit, one descent and one
    beam launch a batch."""
    import numpy as np

    procs, d = builds
    t0 = time.perf_counter()
    for p in procs:
        p.join(timeout=600)
        assert p.exitcode == 0, f"a legacy build failed ({p.exitcode})"
    waited_s = time.perf_counter() - t0
    card, cpu = (np.load(d / f"{dev}.npz") for dev in ("cuda", "cpu"))
    for name in ("neighbors0", "upper", "levels", "vectors"):
        assert np.array_equal(card[name], cpu[name]), \
            f"bulk_build_legacy on the card: {name} differs from the CPU's"
    assert (int(card["entry"]), int(card["max_level"])) == (
        int(cpu["entry"]), int(cpu["max_level"]))
    run = {dev: json.loads((d / f"{dev}.json").read_text())
           for dev in ("cuda", "cpu")}
    counts = collections.Counter(run["cuda"]["counts"])
    batches = -(-(BULK_INT["rows"] - 256) // BULK_INT["batch_size"])
    assert counts["kernel.beam_search.fp32"] == batches, counts
    assert counts["hnsw.descent_launches.fp32"] == batches, counts
    assert not any(run["cpu"]["counts"].get(c) for c in (
        "kernel.beam_search", "kernel.gather_distance")), run["cpu"]
    rec = dict(BULK_INT, card_s=run["cuda"]["seconds"],
               cpu_s=run["cpu"]["seconds"], waited_s=waited_s,
               max_level=int(card["max_level"]), batches=batches,
               h2d_bytes=counts["hnsw.h2d_bytes"],
               beam_search_launches=counts["kernel.beam_search.fp32"],
               descent_launches=counts["hnsw.descent_launches.fp32"])
    log("legacy (a) card == CPU bit for bit on integer l2 rows "
        + json.dumps(rec))
    return rec, counts


def legacy_vs_resident(torch) -> tuple[dict, dict]:
    """(b) ``bulk_build_legacy`` and the resident ``bulk_build`` at MeMemo's
    build widths on the same ``LEGACY_ROWS`` rows, drawn as
    ``benchmarks/bench_build.py`` draws them (``make_corpus`` rows,
    Gaussian queries): wall, rows/s, h2d bytes and their ratio
    (``bench_build``'s ``h2d_vs_legacy``), the kernels' launches, and
    recall@10 of ``LEGACY_QUERIES`` queries (ef 64) against the exact top
    10 -> (record, each build's counters)."""
    import numpy as np
    from repro_torch.configs.mememo import CONFIG
    from repro_torch.core import dispatch
    from repro_torch.core import hnsw as thnsw
    from repro_torch.core import hnsw_build as tb
    from repro_torch.data.synthetic import make_corpus

    cfg = CONFIG.model
    x = make_corpus(LEGACY_ROWS, cfg.dim, seed=0)
    q = np.random.default_rng(7).normal(
        size=(LEGACY_QUERIES, cfg.dim)).astype(np.float32)
    xn, qn = (torch.nn.functional.normalize(torch.from_numpy(a).cuda(),
                                            dim=1) for a in (x, q))
    exact = torch.topk(qn @ xn.T, 10, dim=1).indices.cpu().numpy()
    del xn, qn
    kw = dict(M=cfg.M, ef_construction=cfg.ef_construction,
              metric=cfg.metric, seed=0, bootstrap=256, batch_size=1024)
    batches = -(-(LEGACY_ROWS - 256) // 1024)
    out, paths = {"rows": LEGACY_ROWS, "dim": cfg.dim, **kw,
                  "dtype": "fp32", "batches": batches}, {}
    for name, fn in (("legacy", tb.bulk_build_legacy),
                     ("resident", tb.bulk_build)):
        dispatch.reset()
        t0 = time.perf_counter()
        g = fn(x, device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = collections.Counter(dispatch.snapshot())
        assert counts["kernel.beam_search.fp32"] == batches, (name, counts)
        assert counts["hnsw.descent_launches.fp32"] == batches, (name, counts)
        ids, _ = thnsw.search_graph(thnsw.to_device_graph(g, device="cuda"),
                                    q, k=10, ef=64)
        out[name] = {"wall_s": wall, "rows_per_s": LEGACY_ROWS / wall,
                     "h2d_bytes": counts["hnsw.h2d_bytes"],
                     "recall_at_10": thnsw.recall_at_k(ids.cpu().numpy(),
                                                       exact),
                     "beam_search_launches": counts["kernel.beam_search.fp32"],
                     "descent_launches": counts["hnsw.descent_launches.fp32"],
                     "max_level": g.max_level}
        paths[f"{name} build fp32 D384"] = counts
    out["h2d_vs_legacy"] = (out["resident"]["h2d_bytes"]
                            / out["legacy"]["h2d_bytes"])
    out["wall_legacy_over_resident"] = (out["legacy"]["wall_s"]
                                        / out["resident"]["wall_s"])
    assert out["h2d_vs_legacy"] < 0.5, out
    for name in ("legacy", "resident"):
        assert 0.0 < out[name]["recall_at_10"] <= 1.0, out
    log("legacy (b) against the resident build " + json.dumps(out))
    return out, paths


def run_example(torch, name: str, **kw) -> tuple[dict, dict, float]:
    """One example's ``main(device="cuda")`` with its asserts -> (what it
    returned, the launch counters of the run, seconds)."""
    from repro_torch.core import dispatch

    mod = load_example(name)
    dispatch.reset()
    t0 = time.perf_counter()
    out = mod.main(device="cuda", **kw)
    torch.cuda.synchronize()
    return (out, collections.Counter(dispatch.snapshot()),
            time.perf_counter() - t0)


def example_child(out_dir: str, i: int, name: str, kw: dict) -> None:
    """``run_example`` in a process of its own -> ``out_dir/<i>.json``
    (what ``main`` returned, its launch counters and seconds)."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))

    out, counts, secs = run_example(torch, name, **kw)
    (Path(out_dir) / f"{i}.json").write_text(json.dumps(
        {"out": out, "counts": counts, "seconds": secs}))


def join_examples(handle, timeout: float = 900) -> list[tuple]:
    """The spawned ``example_child`` runs -> [(what main returned,
    counters, seconds)] in their order."""
    procs, d = handle
    got = []
    for i, p in enumerate(procs):
        p.join(timeout=timeout)
        assert p.exitcode == 0, f"example run {i} failed ({p.exitcode})"
        rec = json.loads((d / f"{i}.json").read_text())
        got.append((rec["out"], collections.Counter(rec["counts"]),
                    rec["seconds"]))
    return got


def check_playground(torch, index: str, res: dict, counts, flat_keys):
    """One ``--index`` run of the playground: the path's kernels launched,
    the stats and responses the reference's script prints, and (hnsw,
    tiered) the flat scan's keys -> its record."""
    assert counts["kernel.flash_decode"] > 0, (index, counts)
    if index == "hnsw":
        assert counts["kernel.beam_search"] > 0 and counts[
            "hnsw.descent_launches"] > 0, counts
    if index == "flat":
        assert counts["kernel.distance_topk"] > 0, counts
    if index == "ivf":
        assert hop_launches(counts, "fp32") > 0, counts
    assert res["stats"]["hit_rate"] == 0.25, res["stats"]
    assert all(a["response"].startswith("<") for a in res["answers"])
    keys = [a["keys"] for a in res["answers"]]
    if index in ("hnsw", "tiered"):
        # 12 documents: the graph reaches every one, as the scan does
        assert keys == flat_keys, (index, keys, flat_keys)
    rec = {"keys": keys, "stats": res["stats"],
           "responses": [a["response"] for a in res["answers"]]}
    log(f"example playground --index {index} " + json.dumps(rec))
    return rec


def phase_examples(torch, builds) -> dict:
    """Phase 17: (c)'s four playground runs, host-bound (the engine
    prefills 127 positions in attention blocks of 1), each in a process
    of its own, while this process checks (a) (the legacy builder's card
    and CPU graphs, built since phase 14) and runs (c) quickstart,
    distributed retrieval and fault-tolerant training; then (b) the
    legacy builder against the resident one at MeMemo's widths, alone,
    for its walls."""
    out, seconds, paths = {}, {}, {}
    play = spawn("examples", [
        (example_child, i, "torch_rag_playground", {"index": index})
        for i, index in enumerate(PLAYGROUND_INDEXES)])
    try:
        t = time.perf_counter()
        out["a legacy int l2"], paths["legacy build int l2"] = \
            legacy_bit_identical(torch, builds)
        seconds["a legacy int l2, waited"] = time.perf_counter() - t

        res, counts, seconds["c quickstart"] = run_example(
            torch, "torch_quickstart")
        assert counts["kernel.beam_search"] > 0 and counts[
            "hnsw.descent_launches"] > 0, counts
        assert counts["kernel.distance_topk"] > 0, counts
        assert hop_launches(counts, "fp32") > 0, counts
        out["c quickstart"] = res
        paths["example quickstart"] = counts
        log("example quickstart " + json.dumps(res))

        res, counts, seconds["c distributed"] = run_example(
            torch, "torch_distributed_retrieval")
        assert counts["kernel.distance_topk"] == 8, counts
        assert res["match"] >= 0.99, res["match"]
        if torch.cuda.device_count() == 1:
            assert res["collective_bytes"] == 0, res
        out["c distributed"] = {k: res[k] for k in (
            "mesh", "devices", "match", "collective_bytes", "collectives",
            "kernels")}
        paths["example distributed"] = counts
        log("example distributed " + json.dumps(out["c distributed"]))

        res, counts, seconds["c fault-tolerant"] = run_example(
            torch, "torch_fault_tolerant_training")
        assert res["restarts"] == 2 and res["diff"] < 2e-3, res
        out["c fault-tolerant"] = res
        paths["example fault-tolerant"] = counts
        log("example fault-tolerant " + json.dumps(res))

        t = time.perf_counter()
        played = join_examples(play)
        seconds["c playground, waited"] = time.perf_counter() - t
    finally:
        stop_spawned(play)
    flat_keys = [a["keys"] for a in played[0][0]["answers"]]
    for index, (res, counts, secs) in zip(PLAYGROUND_INDEXES, played):
        out[f"c playground {index}"] = check_playground(
            torch, index, res, counts, flat_keys)
        seconds[f"c playground {index}"] = secs
        paths[f"example playground {index}"] = counts
    release(torch)

    t = time.perf_counter()
    out["b legacy vs resident"], built = legacy_vs_resident(torch)
    paths.update(built)
    seconds["b legacy vs resident"] = time.perf_counter() - t
    out["seconds"], out["counters"] = seconds, paths
    log("phase 17 seconds " + json.dumps(seconds))
    return out


def release(torch) -> float:
    """Drop what the last phase left on the card -> GB still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


def profile_decode(torch, model, cfg, args) -> dict:
    """Where a served decode tick's time goes: wall time per prefill and
    per decode step at the served shapes (slots x max_len), and, from a
    ``torch.profiler`` trace of a few steps, the device-busy time, the
    kernel launches per step and the share of device time per op."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as tf

    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (args.slots, 128), device="cuda",
                         generator=gen)
    _, cache = tf.prefill(model, toks, max_len=args.max_len)
    tok = toks[:, -1:]

    def prefill():
        tf.prefill(model, toks, max_len=args.max_len)

    def step():
        c = tf.KVCache(cache.k, cache.v, cache.cur_len.clone(),
                       cache.k_scale, cache.v_scale)
        tf.decode_step(model, tok, c)

    def wall_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    out = {"prefill_wall_ms": wall_ms(prefill, 3),
           "decode_wall_ms": wall_ms(step, 10)}
    steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    dev = {r.key: r.self_device_time_total / 1e3 for r in rows
           if r.self_device_time_total > 0 and r.key.startswith("aten::")}
    busy = sum(r.self_device_time_total for r in rows
               if r.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    launches = sum(r.count for r in rows if r.key == "cudaLaunchKernel")
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
    out.update(
        decode_device_busy_ms=busy / steps,
        decode_launches=launches / steps,
        decode_top_ops_ms={k: v / steps for k, v in top},
        decode_flash_ms=sum(r.self_device_time_total for r in rows
                            if "flash_decode" in r.key) / 1e3 / steps,
        decode_flash_launches=sum(
            r.count for r in rows if "flash_decode" in r.key and
            r.device_type == torch.autograd.DeviceType.CUDA) / steps,
        shapes=f"slots {args.slots}, prompt 128, max_len {args.max_len}")
    out["decode_idle_share"] = 1.0 - out["decode_device_busy_ms"] / max(
        out["decode_wall_ms"], 1e-9)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: needs PyTorch", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t0 = time.perf_counter()
    seconds = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        left = release(torch)
        seconds[name] = time.perf_counter() - t
        log(f"phase {name}: {seconds[name]:.1f}s, {left:.2f} GB still "
            "allocated")
        assert left < 8, f"phase {name} left its model on the card"
        return res

    smi = phase("1 environment", phase_environment, torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    kern = phase("2 kernels (a)", phase_kernels, torch, gen)
    # the bulk build needs only (a)'s kernels until its exact_query, so it
    # runs while flash_decode's and distance_topk's sources compile
    bulk_out = phase("5 bulk build and store", phase_bulk, torch)
    kern.update(phase("2 kernels (b)", phase_kernels_late, torch, gen))
    build_s = build_report()
    bag_counts = phase("2 embedding_bag entry", bag_entry_run, torch)
    serve_out = phase("3 serve hnsw", phase_serve, torch)
    flat_out = phase("4 serve flat", phase_serve_flat, torch,
                     serve_out["exact_keys"])
    int8_out = phase("6 serve hnsw int8", phase_serve_int8, torch)
    store_out = phase("7 serve hnsw int8 with a store", phase_serve_store,
                      torch)
    ivf_out = phase("8 serve ivf and tiered", phase_serve_ivf, torch)
    ivf_1m = phase("8 ivf 1M int8", phase_ivf_1m, torch)
    shard_out = phase("9 sharded", phase_sharded, torch)
    # minibatch_lg's graph builds on the host while phases 10 to 12 run
    graph = spawn("sage_graph", [(build_sage_graph,)])
    try:
        pool_out = phase("10 tenancy", phase_tenancy, torch)
        other = phase("11 other LMs", phase_other_lms, torch,
                      flat_out["keys"]["int8 served"])
        bf16 = phase("12 bf16", phase_bf16, torch,
                     flat_out["keys"]["int8 served"])
        offpath = phase("13 off-path models", phase_offpath, torch, graph)
    finally:
        stop_spawned(graph)
    # (17 a)'s legacy builds, host-bound, run while phases 14 to 16 do
    builds = spawn("legacy_int", [(build_legacy_int, dev)
                                  for dev in ("cuda", "cpu")])
    try:
        train = phase("14 training", phase_train, torch)
        phase("15 checkpoints and distributed training", phase_ckpt, torch)
        dry = phase("16 dry-run tooling", phase_dryrun, torch, smi)
        examples = phase("17 examples and the legacy builder",
                         phase_examples, torch, builds)
    finally:
        stop_spawned(builds)
    kern["distance_topk.retrieval_cand"] = offpath["mind"]["retrieval_cand"]
    kern["flash_decode.bf16"] = bf16["flash"]
    for arch, rec in other.items():
        kern[f"flash_decode.{arch}"] = rec["flash_served"]
    for c in ("fp32", "int8"):
        kern[f"distance_topk.{c}"]["tenant_slab_scan"] = \
            pool_out[f"arena_{c}"]["slab_scan"]
    kern["distance_topk.int8"]["tenant_slab_scan_4_shards"] = \
        pool_out["sharded"]["slab_scan_per_shard"]
    one_card = shard_out["one_card"]
    kern["distance_topk.int8"]["sharded_4_per_shard"] = \
        one_card["flat"]["shard_topk"]
    kern["gather_distance.int8"]["sharded_4_per_shard_fine"] = \
        one_card["ivf"]["shard_hop"]
    child = shard_out["hnsw"]["child"]
    kern["beam_search.fp32"]["sharded_child"] = child["beam"]
    if "descent" in child:
        kern["greedy_descent.fp32"]["sharded_child"] = child["descent"]
    # the hop kernel at IVF's two shapes, beside its phase 2 cells
    kern["gather_distance.fp32"]["ivf_1m_coarse"] = ivf_1m["hop"]["coarse"]
    kern["gather_distance.int8"]["ivf_1m_fine"] = ivf_1m["hop"]["fine"]
    paths = {"hnsw fp32": serve_out["counters"],
             "flat int8": flat_out["counters"],
             "flat fp32": flat_out["counters_fp32"],
             "flat bf16": flat_out["counters_bf16"],
             "bulk build int8": bulk_out["build_counters"],
             "bulk query int8": bulk_out["query_counters"],
             "hnsw int8": int8_out["counters"],
             "hnsw bf16": int8_out["counters_bf16"],
             "hnsw int8 store cold": store_out["cold"]["counters"],
             "hnsw int8 store warm": store_out["warm"]["counters"],
             **{f"hnsw {c} per-hop beam": int8_out["per_hop_beam"][c]
                for c in CODECS},
             "ivf int8": ivf_out["counters"],
             "ivf fp32": ivf_out["counters_fp32"],
             "ivf bf16": ivf_out["counters_bf16"],
             "tiered fp32": ivf_out["tiered"]["counters"],
             "flat int8 4 shards": one_card["flat"]["counters"],
             "ivf int8 4 shards": one_card["ivf"]["counters"],
             "hnsw fp32 4 shards": shard_out["hnsw"]["counters"],
             "hnsw int8 4 shards served": shard_out["served"]["counters"],
             "pool fp32 B128 across 128 tenants":
                 pool_out["arena_fp32"]["multi_counters"],
             "pool int8 B128 across 128 tenants":
                 pool_out["arena_int8"]["multi_counters"],
             "pool int8 --tenants 4 served cold":
                 pool_out["served"]["cold"]["counters"],
             "pool int8 --tenants 4 served warm":
                 pool_out["served"]["warm"]["counters"],
             **{f"{a} flat int8": other[a]["counters"] for a in OTHER_LMS},
             "h2o-danube-3-4b kv_quant flat int8":
                 other["h2o-danube-3-4b"]["kv_quant_served"]["counters"],
             BF16_LLAMA: bf16["served"]["counters"],
             RETRIEVAL_PATH: offpath["mind"]["counters"],
             BAG_ENTRY: bag_counts,
             TRAIN_PATH: train["llama3-8b"]["counters"],
             **dry["counters"],
             **examples["counters"]}
    for counts in paths.values():
        for c in CODECS:
            counts[f"{HOP_COUNTER}.{c}"] = hop_launches(counts, c)
    line = []
    for name, rec in kern.items():
        base = name.split(".")[0]
        counter = COUNTER_OF.get(name, f"kernel.{name}")
        launches = paths[MAIN_PATH[name]].get(counter, 0)
        assert launches > 0, f"{name} never launched on {MAIN_PATH[name]}"
        line.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/"
                               f"{SOURCE_OF.get(base, base)}.cu",
                     "replaces": REPLACES[base], "launches": launches,
                     "main_path": MAIN_PATH[name],
                     "launches_by_path": {
                         p: c.get(counter, 0) for p, c in paths.items()},
                     **rec})
    log("phase seconds " + json.dumps(seconds) + ", kernel build "
        + json.dumps(build_s))
    log(f"total {time.perf_counter() - t0:.1f}s on {smi}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
