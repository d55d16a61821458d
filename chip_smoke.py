"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. device: the card's name and power limit (nvidia-smi); CUDA must exist;
2. build: every CUDA source of ``stonkgs_tpu_torch/csrc`` with nvcc, all
   started together, with ptxas's register and spill report (fatal if any
   Hopper kernel spills: the attention forward and backward, the FFN
   block's GEMM and LayerNorm passes, the training FFN's GEMMs and dual
   GEMM, the BigBird forward and backward, the int8 dense's row-quantize
   pass and the int8 GEMM of the dense and the probe);
3. kernels: the serving kernels against their plain PyTorch versions on
   the card, in bf16 and fp32, at the serving paths' shapes (the FFN
   block at H=768 with gelu and gelu_new and at ProtBERT's H=1024, at
   M = 0, 1, 3, 127, 128, 129, 1,000, 6,144, 24,576, 32,768 and 65,536;
   attention up to S=1024 and at ProtBERT's S=3072 with 16 heads), then
   the bf16 attention at the edges of its 128-row tiles (S = 63, 64, 65,
   127, 128, 129, 200, 3000; B=H=1 and B=8; masked, unmasked, and a row
   whose keys are all at -1e9); bf16 attention outputs are also held
   within one bf16 step of the output's scale (``ATTN_STEP``), and at
   S=3000 that limit must reject the plain output without one key tile;
4. training kernels: the attention forward (rate 0 and 0.1, S = 1, 129,
   260, 300, 512, 1024, and S=3072 with 16 heads, where the output limit
   must reject a missing keep scale), the attention backward (rates 0 and
   0.1, with and without db, S = 1, 63, 64, 65, 127, 128, 129, 260, 300,
   512 and 1024, at B=H=1 and at the step's B=32 H=12, masked, unmasked
   and with a row whose keys are all at -1e9; bf16 gradients also within
   ``ATTN_STEP`` of their scale, a limit that must reject dK without its
   scale and dV without the keep scale) and the FFN pair (M = 0, 1, 3,
   127, 128, 129, 1,000, 8,192, 16,384 with gelu and gelu_new; bf16 at
   I=992; H=1024 at M = 3 and 6,144; the bf16 dh limit must reject a dh
   whose gelu' lacks its h-dependent term), against their plain versions,
   in bf16 and fp32;
5. serving: ``STonKGsEngine.embed`` at full BERT-base width (backbone and
   trunk, 256 + 256, KG vocabulary 100,000, random seeded weights) on 512
   rows, in parity mode and with ``length_buckets=(64, 128)``; checks the
   kernels' launch counts, finite output, the card in fp32 against the
   CPU in fp32, and the card in bf16 against the CPU in fp32;
6. timing: embed throughput, and each serving kernel's time at the path's
   shapes beside its bound, its plain version and PyTorch's SDPA (for
   attention also its TFLOP/s and its time as a multiple of SDPA's; for
   the FFN block the two cuBLAS products it contains, timed alone);
7. training: ``pretrain`` at full width (B=32, fp32 parameters, bf16
   compute, synthetic batches with int(0.15*len) masked positions per
   half); checks the training kernels' launch counts, a finite loss at
   every step, the frozen backbones bit-unchanged and the trainable
   parameters changed;
8. training numerics: the loss and trunk gradients on the card in fp32
   against the CPU in fp32 (2 rows, 2 layers, attention dropout 0.1 with
   the same seeds, hidden dropout 0), then on the card in bf16 through
   the Hopper kernels against the same CPU fp32 run (loss within 1e-2
   relative, every gradient leaf at a cosine of at least 0.99);
9. training timing: ms per step and examples/s (median of 6 steps after 2
   of warm-up), and each training kernel's time at the step's shapes
   beside its bound, its plain version and, for attention, SDPA (the
   backward: ``torch.autograd.grad`` alone over a saved SDPA forward,
   with the backend that ran), for the FFN pair the cuBLAS products it
   contains, timed alone;
10. sparse kernels: the BigBird pair against its plain versions, bf16 and
    fp32, at D=64, block size 64 (nb = 5, 8 with a padded mask, and 64:
    S=4096) and 128 (nb = 5, 8 padded, and 32: S=640, 1,024 and 4,096), with the
    eval and the training plan, at B=2 (forward and backward) and B=8
    (forward); bf16 contexts also within ``ATTN_STEP`` of their scale,
    bf16 gradients within it plus ``GRAD_STEP_FLOOR``; at S=4096, at each
    block size, the limits must reject a context without one random slot,
    a context without the duplicate window slot's penalty and dK without
    the g0 slot's adds;
11. ProtSTonKGs serving: ``ProtSTonKGsEngine.embed`` at full width
    (BigBird trunk 12 x 768, BioBERT 12 x 768, ProtBERT 30 x 1024, KG
    vocabulary 20,000, seeded random weights) on 32 rows at B=8; checks
    the launch counts, finite output, and, at 2 layers a stack, the card
    in fp32 and bf16 against the CPU in fp32;
12. ProtSTonKGs training: ``pretrain(..., loss_fn=protstonkgs.
    pretraining_loss)`` at full width (B=2, 4 steps, the training plan);
    checks the launch counts, finite losses, the three backbones
    bit-unchanged and the trunk and projection trained;
13. ProtSTonKGs training numerics: loss and gradients, card fp32 against
    CPU fp32, at 2 layers a stack (hidden dropout 0, the backbones'
    attention dropout 0.1 on the same seeds), with the trunk at block 64
    and again at block 128;
14. ProtSTonKGs timing: embed sequences/s, ms per step (median of 6 after
    2), and each new or widened kernel at the path's shapes beside its
    bound and its plain version (the training FFN pair at ProtBERT's,
    the BigBird trunk's and BioBERT's shapes; the BigBird pair also
    beside its floor and SDPA over operands gathered beforehand, its
    backward alone over a saved forward);
15. int8 kernels: the fused int8 dense against its plain version, bf16
    and fp32, at every shape of the int8 serving paths, at M = 0, 1 and
    300, an all-zero row, N = 100, the decoders' N = 28,996 and 100,000,
    K = 48 and 784 (K % 32 == 16), a strided ``x[:, :1]`` and a
    row-major weight (copied for the call); its row-quantize pass's codes
    and scales equal to ``quantize_rows`` bit for bit at every shape; the
    limits shown to reject codes made with a reciprocal and an epilogue
    without s_w; the int8 GEMM probe exactly equal to its plain version
    at 512 x 1024 x 512 and 4096^3, bf16 within tolerance;
16. int8 serving: ``quantize_params`` on phase 5's parameters, then
    ``STonKGsEngine.embed`` on 512 rows at B=128 in bf16; checks the
    launch counts (144 int8 denses, 23 attentions, no FFN block a batch),
    every quantized weight of the engine column-major (the kernel reads
    it without a copy), finite output, card fp32 against CPU fp32 (both
    int8; cosine 0.9999 at 2 layers a stack; at full depth each layer fed
    the CPU's input, cosine 0.9999 and at most 1e-3 of its activation
    codes flipped, where the bf16 control must flip more; end to end
    0.999 against gross faults) and card bf16 against CPU fp32; int8 and
    bf16 pairs/s in turns;
17. ProtSTonKGs int8 serving: the same with ``ProtSTonKGsEngine`` at full
    width on 32 rows at B=8 (325 int8 denses, 42 attentions, 11 sparse
    a batch) and at 2 layers a stack against the CPU; sequences/s in
    turns with bf16;
18. int8 timing: the int8 dense at each path shape beside its bound, its
    plain version, ``torch._int_mm`` on codes made beforehand (with the
    column-major weight) and the bf16 dense it replaces, and its two
    launches timed apart, each beside its own bound (the pass by bytes,
    the GEMM by bytes or operations; their sum is the design's floor);
    the probe's ``main`` (its exactness checks,
    then ``torch.mm`` bf16, ``torch._int_mm`` and the kernel on int8 and
    on bf16 at 4096^3, in TFLOP/s);
19. README flow from files: the port's ``save_pretrained`` writes a
    BERT-base checkpoint (seeded random parameters, KG vocabulary 5,000)
    to a temporary directory, beside a 28,996-line vocabulary with
    BioBERT's special ids and node2vec TSVs (5,000 BEL-named entities,
    dim 768, walks of 127: the 256 + 256 layout); then
    ``STonKGsEngine.from_pretrained`` (B=128) -> ``preprocess`` (512
    rows, evidence of 10..256 word pieces, 8 sources not in the KG) ->
    ``embed``, parity and with ``length_buckets=(64, 128)``; checks the
    native tokenizer, its features equal to the Python tokenizer's, the
    loaded parameters and KG table bit for bit, the embeddings equal to
    an engine's built from the parameters in memory (bf16, and fp32 on 8
    rows), the launch counts and finite output; times the tokenizer's
    build, ``from_pretrained`` and its parts, ``preprocess`` and its
    parts, ``embed`` alone and raw rows -> embeddings.  The directory is
    removed at the end.
20. fine-tuning: (a) ``classification_loss`` and its trunk and
    classifier gradients at 2 rows and 2 layers a stack of the full
    width (hidden dropout 0, attention dropout 0.1 on the same seeds),
    card fp32 against CPU fp32 (loss 1e-4 relative, gradients 1e-3 of
    max |grad|) and card bf16 against it (loss 1e-2, every leaf at a
    cosine of 0.99); (b) ``run_sequence_classification_cv`` at phase 5's
    width and weights (fp32 on the card, bf16 compute) on 80 rows, 2
    folds, 1 epoch, B=8, eval B=64, into a temporary directory: launch
    counts, finite losses, F1s in [0, 1], the tree passed in bit-unchanged,
    every trainable leaf but the trunk's word embeddings and ``cls/*``
    trained, the TSV's 80 rows and labels, the exported model read back
    equal to the last fold's; (c) the TransE layout (S=260) and (d)
    ProtSTonKGs at phase 11's width (B=2, the training plan, backbones
    unchanged), each ``cv=1`` for one epoch; (e) the NLP baseline
    (BioBERT 12 x 768 trained whole, S=512, B=16) in fp32 and in bf16;
    (f) the KG baseline on node2vec features (200, 254, 768) on the card,
    F1 above 0.9; (g) the fine-tuning step at B=8 and the NLP baseline's
    at B=16 (median of 6 after 2, forward+backward and optimizer apart),
    ``predict`` sequences/s at B=64, and the training kernels at
    fine-tuning's shapes beside their bounds, plain versions and library
    calls.
21. pre-training from files: (a) a memmap store of 1,024 rows (S=512,
    int(0.15 * 256) = 38 masked positions a half, NSP labels), phase 19's
    node2vec TSVs (5,000 x 768) and vocabulary in a temporary directory;
    (b) ``run_pretraining`` from the store at BERT-base width (B=32, 6
    steps, a save every 3, bf16 compute, frozen backbones in bf16), twice:
    launch counts, finite logged losses, checkpoints 3 and 6, the frozen
    backbones in bf16 and unchanged, the two runs' spread; (c) checkpoint
    6 deleted, the identical call resumes at 3 and logs 4-6 only, held to
    the run-to-run spread or to a 1e-3 relative loss gap and an update
    cosine of 0.9999 a trainable leaf; (d) the HF export read back by
    ``from_pretrained``, its leaves equal to the run's and its embeddings
    equal to an engine's on the run's parameters; (g) ``embed_stream``
    over phase 19's 512 raw rows in chunks of 128, equal to ``embed`` bit
    for bit, ``_dispatch`` under the sync debug mode "error"; (h) ms a step
    from the store beside one batch on the card, checkpoint GB and save /
    restore seconds, ``embed_stream`` rows/s beside sequential raw rows
    -> embeddings and ``embed`` alone; (f) ``pretrain`` with
    ``dynamic_masking_loss`` (B=32, 4 steps), then ``mask_tokens_torch``
    (38 positions a row a half, 80/10/10 within 4 sigma) and
    ``dynamic_nsp_swap`` (20% negatives within 4 sigma) on the card over
    the store; (e) ``variant="transe"`` (S=260, B=32, 2 steps) and
    ``variant="prot"`` at phase 11's widths (B=2, 2 steps, one save).
22. KG embeddings: (a) a seeded synthetic INDRA corpus (communities of
    50 agents, hubs, complexes, TEXT agents, small components, the four
    contexts) through ``read_indra_triples``: the files, their counts
    against the summary, one component of 10,000-20,000 nodes; (b)
    ``run_node2vec`` from the extracted pre-training TSV on the card at
    the reference's settings (dim 768, walks of 127, 4 epochs, window 3,
    5 negatives, 1 iteration), with the host and with the device
    pipeline: the native walker, the TSVs' shapes and row pairing,
    finite vectors, the link-prediction AUC at least ``KG_AUC_MIN`` and
    the edges' mean centred cosine ``KG_COS_MARGIN`` above random pairs';
    (c) one host-pipeline step (65,536 pairs) and one device slab (2^17
    slots, its draws made on the card) on the card against the CPU on equal
    inputs (``KG_CARD_TOL``), the slab's keep, window and negative rates
    within 4 sigma and its mask density within 3% of ``_make_pairs``'s;
    (d) ``save_pretrained`` (BERT-base, the new graph's KG vocabulary) ->
    ``STonKGsEngine.from_pretrained`` on the trained TSVs ->
    ``preprocess`` of 512 extracted rows -> ``embed`` (launch counts,
    finite output), then the KG battery over the extracted tasks after
    ``filter_out_duplicates`` (cv 2, 1 epoch); (e) at 500,000 nodes: the
    walker's steps/s, the host pipeline's pairs/s and step, the device
    pipeline's slab in ms and tokens/s, its busy share under the
    profiler, peak memory, and both pipelines' projected minutes for
    254 M tokens.
23. parallelism on torch.distributed, at phase 5's width (B=32, 4 steps,
    bf16 compute): (a) ``pretrain(mesh=make_mesh(1, 1))`` in a world of one
    on NCCL, equal bit for bit to the unmeshed run; (b) two ranks on
    cuda:0 over gloo (``multihost.launch``, torchrun's variables), each on
    a 1x2 mesh (the KG table and the decoders split), 2x1 with FSDP and
    2x1 plain: launch counts a rank, equal logged losses and bit-equal
    replicated leaves and moments on both ranks, each run held to one
    rank's within the spread of a one-rank run that sums its batch in two
    halves or within ``PAR_LOSS_GAP`` / ``PAR_UPDATE_COS`` /
    ``PAR_NU_GAP``, peak memory and parameter bytes a rank, step seconds
    under gloo (not a throughput); (c) ProtSTonKGs on 1x2 at 2 layers a
    stack in fp32 against one rank (an update cosine of at least
    ``PAR_FP32_UPDATE_COS``: the mesh draws the unmeshed run's dropout
    masks), then at phase 11's widths in bf16 (B=2, 2 steps, the training
    plan) against one rank, within 4 of the widest spread of
    ``PAR_PROT_PAIRS`` more one-rank runs or within the limits; (d) ``train_classifier`` on 2x1 (B=8, 2 steps) against one rank; (e)
    ``run_pretraining(n_model_shards=2)`` from a memmap store, saved at 2,
    resumed from it and equal to the uninterrupted run.
24. the command line, the published-model API and remat, at phase 19's
    files (BERT-base, KG vocabulary 5,000, a 28,996-line vocabulary)
    written under a temporary ``STONKGS_TPU_CACHE`` exactly where
    ``utils/cache.py::ensure`` maps the published URLs, with
    ``urllib.request.urlretrieve`` patched to fail: (a)
    ``STonKGsEngine.from_default_pretrained()`` -> ``embed`` of 512 rows
    (phase 5's launch counts, finite) and ``infer_species`` (probabilities
    summing to 1 within 1e-5, equal to ``predict_proba`` of
    ``from_pretrained`` on the same files within ``CLI_INFER_TOL``); (b)
    ``python3 -m stonkgs_tpu_torch`` as subprocesses: ``--version``,
    ``embed`` at B=128 (its TSV within ``CLI_INFER_TOL`` of the in-process
    embed), ``verify-parity --tolerance 1e-3`` (PASS, exit 0) and the same
    on a copy whose NSP bias is shifted by 1e-2 (FAIL, exit 1),
    ``preprocess`` then ``pretrain --max_steps 2 --num_hidden_layers 2
    --remat full`` (finite logged losses, checkpoint 2); (d)
    ``utils/profiling.trace`` over one embed batch names the serving
    kernels, and ``StepTimer``'s p50 over 6 batches is within 10% of CUDA
    events; (c) phase 5's model (dropout 0.1) at B=32, 4 steps of
    ``make_train_step`` under remat none, full and attention from the same
    seeds: losses and every trainable leaf bit-equal to none, the
    recompute's launches (full: the trunk's attention and FFN forwards
    twice, attention: the attention forward twice), peak memory above the
    start (full below none) and ms a step; then ProtSTonKGs at phase 11's
    widths (B=2, 2 steps) under attention against two none runs, within
    4 of their spreads as phase 23 holds a mesh (its BigBird backward adds
    with atomics), ``bigbird_mid_fwd`` twice a trunk layer.
25. ProtSTonKGs at ``block_size=128`` (runs right after phase 14, on
    phase 11's parameters and rows, the trunk's config replaced): (a)
    ``ProtSTonKGsEngine.embed`` at B=8 on 32 rows (11 ``bigbird_mid_fwd``
    a batch), 2 of its rows against the card's fp32 engine at full depth
    (cosine 0.99); (b) ``pretrain`` at B=2 for 2 steps (12 + 12 sparse
    launches a step, finite losses, frozen backbones unchanged); (c)
    ``save_protstonkgs_pretrained`` -> ``ProtSTonKGsEngine.from_pretrained``
    with a config.json of block size 128 (KG vocabulary cut to 5,000 with
    node2vec TSVs of that size), its embeddings equal to an in-memory
    engine's bit for bit; (d) sequences/s and the step's median ms beside
    phase 14's at block 64, and the pair at the path's three shapes
    (B=8 eval plan, B=2 training plan forward and backward) beside its
    bound, floor, plain version, SDPA over gathered operands and the
    block-64 time of the same run.
26. widths: (a) the attention kernels at D = 16 and 32 (inference, the
    training forward at rates 0 and 0.1, its output limit shown to reject
    another seed's mask, and the backward), S = 1, 63, 129, 300 and 512,
    B=1 and B=8 with a row whose keys are all at -1e9, and the three FFN
    kernels at H = 32, 64, 96, 384 and 512, I = 4H, M = 3, 129 and 8,192,
    gelu and gelu_new, against their plain versions in bf16 and fp32;
    D = 136 and 256, H = 2,056 and I = 8,200 (the FFN's edges since
    phase 29) and BigBird's D = 72 raise, and the C entry points refuse
    D = 136 and 68, H = 2,056, I = 8,200 and BigBird's D = 72 and 36;
    (b) STonKGs at
    MiniLM-L12-H384's widths (12 x 384, 12 heads of 32, I=1536,
    vocabulary 30,522, KG vocabulary 100,000, seeded random weights):
    phase 5's checks on 512 rows at B=128, then the card's fp32 engines
    on all rows, parity and bucketed, and bf16 against fp32 by cosine
    (``WIDTH_COS_ALL`` over all rows, ``WIDTH_COS_ROW`` a row); (c)
    phase 7's ``pretrain`` (B=32, 4 steps, dropout 0.1) and phase 8's
    numerics at those widths; (d) ``run_pretraining`` from a memmap store
    and 32- and 64-wide node2vec TSVs (the derived configs: D=16 and
    D=32), 2 steps with an HF export, then ``from_pretrained`` ->
    ``embed`` on the card in fp32 and bf16 against the CPU; (e) the
    MiniLM embed's pairs/s and step's ms, and the six kernels at its
    shapes beside their bounds, plain versions and library calls.
27. BigBird's widths: (a) the kernel pair at D=32 and block sizes 8, 48,
    64, 96, 128, 256, 512 and 1,024 (nb=8, 3 heads, a padded mask), at
    block 96 with nb=5, and at D=16 and blocks 64 and 512 (4 heads),
    with the eval and the training plan, r=1, B=2, forward (lse too) and
    backward in bf16 and fp32, within phase 10's limits; at blocks 96
    and 512 the limits must reject a key past the block let into the
    softmax, query rows past the block let into dK, and (on integer q and
    k, where the kernel is held to them first) the D=32 logit's second
    rounding left out; D = 4, 72 and 128 and blocks 12 and 2,048 raise
    in both wrappers and dtypes with no launch counted, and the C entry
    points refuse them; (b) ``run_pretraining(variant="prot")`` from a
    memmap store and a synthetic 128-wide node2vec TSV of 20,000 nodes
    (the derived config: stacks of 2 x 128, 4 heads of D=32, block 512,
    r=1, at 768 | 256 | 3072), B=2, 2 steps, one save: launch counts,
    finite losses, frozen backbones unchanged, the loss and trunk
    gradients card fp32 against CPU fp32 (phase 13's limits), then
    ``ProtSTonKGsEngine.embed`` on the trained parameters (32 rows, B=8):
    card fp32 against CPU fp32 on 8 rows (1e-3 of max |CPU|), card bf16
    against card fp32 by cosine (phase 26's limits); again from a
    32-wide TSV (D=16) and at S=768 (384 | 128 | 256, block 96); (c) the
    128-wide path's embed sequences/s and step ms, and the pair at its
    shapes beside its bound, floor, plain version and SDPA over gathered
    operands.
28. head widths: (a) the three attention kernels at D = 8, 24, 48, 68,
    72, 80, 96, 112 and 128 (instances of the padded widths 16, 32, 64
    and 128; D=68 through the wrappers' zero-padded copies), S = 1, 65
    and 512, B=2 with 3 heads, against their plain versions in bf16 and
    fp32: inference with a key bias whose batch row 0 is all -1e9 and
    without one, the training forward at rates 0 and 0.1, the backward
    at both (with and without db, unmasked, the dead row); at D = 80 and
    128 the limits must reject the plain output without the scores'
    columns from 64 on and under another seed's mask, and at S=512 dK
    without its scale and dV without the keep scale; (b) STonKGs at
    BERT-base's widths with 6 heads of D=128 on phase 5's parameters:
    ``embed`` of 512 rows at B=128 (launch counts, finite, card fp32
    against CPU fp32 on 4 rows, bf16 by cosine), phase 7's ``pretrain``
    (B=32, 4 steps) and phase 8's numerics; (c) ``run_pretraining`` ->
    ``from_pretrained`` -> ``embed`` from 96-, 160-, 288- and 544-wide
    KG TSVs (the derived 2-layer configs: D = 48, 80, 72, 68), as phase
    26 (d); (d) the three kernels at (b)'s shapes beside their bound,
    the design's floor, their plain versions and SDPA (the backward:
    its own alone over a saved forward).
29. wide: (a) the three FFN kernels at H = 16, 48, 100, 112, 144, 1,056,
    1,280 and 2,048 with I = 4H, 100 and 1,000, M = 3 and 200, gelu (and
    gelu_new at I = 4H), against their plain versions in bf16 and fp32;
    at H=100 the limits must reject the serving block with its LayerNorm
    statistics over the padded width (104 in bf16, 128 in fp32) and the
    serving block and the training forward without the W2 product's last
    partial tile of 64 columns; (b) the BigBird pair at D = 8, 24, 36, 40,
    48 and 56 (padded instances; D=36 through the wrappers' zero-padded
    copies), blocks 64 (nb=8, 3 heads, a padded mask) and 96 (nb=5), as
    phase 27 (a), and at D=24 on integer q and k the kernel within the
    limits and the plain output at the padded instance's scale 1/sqrt(32)
    rejected; (c) ``run_pretraining`` -> ``from_pretrained`` -> ``embed``
    from 48-, 80-, 100-, 112- and 1,280-wide KG TSVs (the derived configs:
    2 heads of 24, 40, 50 and 56, 20 heads of 64 at I = 5,120; 1,000 KG
    entities) and ``variant="transe"`` from the 80-wide one (508 + 4), as
    phase 26 (d),
    and ``run_pretraining(variant="prot")`` -> ``embed`` from 48-, 80- and
    144-wide TSVs (trunk and backbones at D = 24, 40 and 36; blocks 96 and
    512), as phase 27 (b).

The line before the last is a JSON object with one entry per kernel (the
BigBird pair's times at block 64, its error the worse of both block
sizes), then one for each of the six attention and FFN kernels at
MiniLM-L12-H384's widths (``<name> H=384 D=32``: the launches of phase
26's embed and step, the worst bf16 error of phase 26 at any new width),
then the BigBird pair at the 128-wide ProtSTonKGs path's shapes
(``<name> D=32``: the launches of phase 27's runs, the worst bf16 error
of phase 27 at any new geometry), then the three attention kernels at 6
heads of D=128 (``<name> D=128``: the launches of phase 28's embed and
step, the worst bf16 error of phase 28 at any head width); the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import functools
import itertools
import json
import math
import os
import re
import statistics
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from stonkgs_tpu_torch import ProtSTonKGsEngine, STonKGsEngine
from stonkgs_tpu_torch.baselines import batteries, kg_baseline, nlp_baseline
from stonkgs_tpu_torch.cli.pretrain import (
    prot_pretraining_config,
    run_pretraining,
    stonkgs_pretraining_config,
)
from stonkgs_tpu_torch.config import BertConfig, BigBirdConfig, ProtSTonKGsConfig, STonKGsConfig
from stonkgs_tpu_torch.data.artifacts import (
    load_kg_artifacts,
    make_random_artifacts,
    read_tsv,
    save_kg_artifacts,
)
from stonkgs_tpu_torch.data import (
    fast_tokenizer,
    filters,
    indra_extraction,
    kg_graph,
    tsv_io,
    walker,
)
from stonkgs_tpu_torch.data.fast_tokenizer import FastBertTokenizer
from stonkgs_tpu_torch.data.masking import mask_tokens, mask_tokens_torch
from stonkgs_tpu_torch.data.memmap_dataset import MemmapFeatureStore
from stonkgs_tpu_torch.data.preprocessing import assemble_entity_half, preprocess_for_embeddings
from stonkgs_tpu_torch.data.walker import CSRGraph
from stonkgs_tpu_torch.data.wordpiece import BertTokenizer
from stonkgs_tpu_torch.models import bert, node2vec, protstonkgs, stonkgs, word2vec
from stonkgs_tpu_torch.models.heads import init_classifier_head
from stonkgs_tpu_torch.ops import _build
from stonkgs_tpu_torch.ops import bigbird_sparse as bigbird_sparse_ops
from stonkgs_tpu_torch.ops import flash_attention as flash_attention_ops
from stonkgs_tpu_torch.ops import fused_ffn as fused_ffn_ops
from stonkgs_tpu_torch.ops.bigbird_sparse import (
    _blocked,
    _mid_logits,
    _mid_operands,
    bigbird_mid_bwd,
    bigbird_mid_bwd_plain,
    bigbird_mid_fwd,
    bigbird_mid_fwd_plain,
    build_rand_attn,
)
from stonkgs_tpu_torch.ops.flash_attention import (
    flash_attention_infer,
    flash_attention_infer_plain,
)
from stonkgs_tpu_torch.ops.flash_attention import (
    flash_attention_train_bwd,
    flash_attention_train_bwd_plain,
    flash_attention_train_fwd,
    flash_attention_train_fwd_plain,
)
from stonkgs_tpu_torch.ops.fused_ffn import (
    fused_ffn_bwd,
    fused_ffn_bwd_plain,
    fused_ffn_fwd,
    fused_ffn_ln_block,
    fused_ffn_ln_block_plain,
    fused_ffn_plain,
)
from stonkgs_tpu_torch.ops.quantization import (
    _dequant_plain,
    dense_int8_fused,
    dense_int8_fused_plain,
    dense_int8_gemm,
    dense_int8_quantize,
    is_k_major,
    is_quantized,
    k_major,
    padded_k,
    quantize_kernel,
    quantize_params,
    quantize_rows,
)
from stonkgs_tpu_torch.benchmarks import bench_int8_gemm
from stonkgs_tpu_torch.benchmarks.bigbird_sdpa import gathered_operands, sdpa_mid, to_ctx
from stonkgs_tpu_torch.benchmarks._util import time_ms
from stonkgs_tpu_torch.benchmarks.bench_int8_gemm import int8_gemm, int8_gemm_plain
from stonkgs_tpu_torch.train import finetuning, pretraining
from stonkgs_tpu_torch.train.checkpoint import CheckpointManager
from stonkgs_tpu_torch.train.dynamic_masking import dynamic_masking_loss, dynamic_nsp_swap
from stonkgs_tpu_torch.train.optimizer import AdamW, merge_frozen, split_frozen
from stonkgs_tpu_torch.utils import hf_loader
from stonkgs_tpu_torch.utils.convert import params_to
from stonkgs_tpu_torch.utils.hf_export import save_pretrained, save_protstonkgs_pretrained
from stonkgs_tpu_torch.utils.logging import RunLogger
from stonkgs_tpu_torch.utils.batching import host_to_device
from stonkgs_tpu_torch.utils.tree import tree_flatten_with_path, tree_leaves, tree_map

DEV = "cuda"
BF16 = torch.bfloat16
F32 = torch.float32
I8 = torch.int8
# H100 SXM data-sheet peaks (dense): tensor-core bf16 and int8, fp32
# outside the tensor cores, and HBM3 bandwidth
PEAK_FLOPS = {BF16: 989e12, F32: 67e12, I8: 1979e12}
HBM_BYTES_PER_S = 3.35e12
# the SFU's exp rate: 16 ex2 a clock on each of 132 SMs at 1.98 GHz
EX2_PER_S = 132 * 16 * 1.98e9
# kernel vs plain on the card: fp32 sums run in another order; bf16 may
# round an intermediate or the output to the other neighbour (one bf16
# step is 2^-7 relative)
TOL = {F32: dict(atol=1e-4, rtol=0.0), BF16: dict(atol=2e-2, rtol=1e-2)}
# the bf16 attention output, besides TOL, elementwise within one bf16 step
# (2^-7) of max |plain| plus one step of itself: at long S the output is
# small (rms about sqrt(e / S), 0.03 at S=3072), where TOL's atol alone
# would pass a missing dropout keep scale or a dropped key tile.  The bf16
# attention gradients are held to the same elementwise limit besides
# GRAD_TOL (which holds only the largest error against the largest value),
# plus GRAD_STEP_FLOOR: a gradient that cancels to 0 in the plain version
# (S=1: one key, so dS = p (dP - delta) = 0) comes out at the fp32
# rounding level
ATTN_STEP = 2.0 ** -7
GRAD_STEP_FLOOR = 1e-4
# gradients and backward outputs are sums over up to 1,024 rows of
# products of rounded operands, so their error grows with their size:
# the tolerance is relative to the largest value (fp32: sums in another
# order; bf16: an operand rounded to the other neighbour, one step 2^-8)
GRAD_TOL = {F32: 1e-4, BF16: 2e-2}
# the int8 dense in fp32 against its plain version: the same codes and
# the same rounded epilogue, so equal up to 1e-6 of the largest output
INT8_F32_TOL = 1e-6
SOURCES = ("ffn_ln_block", "flash_attention_infer", "flash_attention_train", "ffn_train",
           "bigbird_sparse", "dense_int8", "int8_gemm")
# the Hopper (wgmma, TMA) kernels of each library (the attention pair's
# past D = 256 and BigBird's forward past 64 too), and the SIMT kernels past
# their widest instances (the attention kernels' in fp32, BigBird's
# backward in both dtypes and its forward in fp32), which must not spill
SM90_KERNELS = {
    "flash_attention_infer": ("attn_fwd_sm90_kernel", "attn_fwd_wide_sm90_kernel",
                              "attn_fwd_rows_kernel"),
    "flash_attention_train": ("attn_fwd_sm90_kernel", "attn_fwd_wide_sm90_kernel",
                              "attn_bwd_dq_sm90_kernel", "attn_bwd_dkdv_sm90_kernel",
                              "attn_bwd_ds_wide_sm90_kernel", "attn_bwd_gemm_wide_sm90_kernel",
                              "attn_fwd_rows_kernel", "attn_bwd_dq_rows_kernel",
                              "attn_bwd_dkdv_rows_kernel"),
    "ffn_ln_block": ("gemm_sm90_kernel", "add_layer_norm_kernel", "layer_norm_rows_kernel"),
    "ffn_train": ("gemm_sm90_kernel", "ffn_bwd_dual_sm90_kernel"),
    "bigbird_sparse": ("bigbird_fwd_sm90_kernel", "bigbird_bwd_sm90_kernel",
                       "bigbird_fwd_wide_sm90_kernel", "mid_fwd_kernel", "mid_bwd_kernel"),
    "dense_int8": ("quantize_rows_kernel", "gemm_kmajor_sm90_kernel"),
    "int8_gemm": ("gemm_kmajor_sm90_kernel",),
}
# rows of the FFN block's checks: empty, ragged, the edges of the 128-row
# tile, the ProtSTonKGs BioBERT (6,144) and ProtBERT (24,576) shapes, the
# STonKGs backbone and BigBird trunk (32,768) and the STonKGs trunk
FFN_ROWS = (0, 1, 3, 127, 128, 129, 1000, 6144, 24576, 32768, 65536)
# rows of the training FFN pair's checks: empty, ragged, the edges of the
# 128-row tile, and the STonKGs step's backbone and trunk
TRAIN_FFN_ROWS = (0, 1, 3, 127, 128, 129, 1000, 8192, 16384)
# sequence lengths of the attention backward's checks: one key, the edges
# of the 64- and 128-row tiles, TransE's 260, S_pad > S (300), and the
# paths' 512 and 1024
ATTN_BWD_S = (1, 63, 64, 65, 127, 128, 129, 260, 300, 512, 1024)
BATCH = 128
ROWS = 512
BUCKETS = (64, 128)
TRAIN_BATCH = 32
TRAIN_STEPS = 4      # steps of the pretrain run whose launches are counted
ATTN_RATE = 0.1      # the model's attention dropout


class SmokeFailure(Exception):
    """A phase found the port wrong or missing on the card."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    log(f"# build: {time.perf_counter() - t0:.1f} s for {len(SOURCES)} sources "
        f"(nvcc in parallel)")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line.lower():
                log(f"# ptxas {name}: {line.strip()}")
    # no Hopper kernel may spill (every instantiation)
    for name, kernels in SM90_KERNELS.items():
        if name not in _build.build_logs:
            log(f"# ptxas {name}: library not rebuilt, no report to check")
            continue
        spills = _ptxas_spills(_build.build_logs[name])
        for kernel in kernels:
            found = {f: n for f, n in spills.items() if kernel in f}
            check(bool(found), f"{name}: no ptxas report for {kernel}")
            for fn, (stores, loads) in found.items():
                check(stores == 0 and loads == 0,
                      f"{name}: {fn} spills ({stores} bytes stored, {loads} loaded)")
            log(f"# ptxas {name}: {kernel} x{len(found)} without spills")


def _ptxas_spills(text: str) -> dict:
    """{function: (spill store bytes, spill load bytes)} from ptxas -v."""
    spills, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn is not None:
            spills[fn] = (int(m.group(1)), int(m.group(2)))
            fn = None
    return spills


def _bias(B: int, S: int, gen: torch.Generator) -> tuple:
    """Random right-padding: (B, 1, 1, S) fp32 key bias and (B, S) keep mask
    (drawn on ``gen``'s device, a CPU or a card generator)."""
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device=gen.device)
    keep = torch.arange(S, device=gen.device)[None, :] < lengths[:, None]
    bias = ((1.0 - keep.float()) * -1e9)[:, None, None, :]
    return bias.to(DEV), keep.to(DEV)


def _attn_inputs(B, S, dtype, gen, masked=True, H=12, D=64):
    q, k, v = (torch.randn(B, S, H, D, generator=gen, device=gen.device).to(DEV, dtype)
               for _ in range(3))
    bias, keep = _bias(B, S, gen) if masked else (None, None)
    return q, k, v, bias, keep


def _ffn_inputs(M, dtype, gen, H=768, I=3072, fan_in=False):
    """x, attn_out, LN1, W1, b1, W2, b2, LN2 of the serving block (fp32
    vectors, weights in dtype): the weights at std 0.02, or with
    ``fan_in`` at 1/sqrt(fan-in), so that at any width the products and
    their gradients are of order 1."""
    def n(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=gen, device=gen.device)).to(DEV)
    s1, s2 = (H ** -0.5, I ** -0.5) if fan_in else (0.02, 0.02)
    return [n(M, H).to(dtype), n(M, H).to(dtype),
            n(H, std=0.1, mean=1.0), n(H, std=0.1),
            n(H, I, std=s1).to(dtype), n(I, std=0.02),
            n(I, H, std=s2).to(dtype), n(H, std=0.02),
            n(H, std=0.1, mean=1.0), n(H, std=0.1)]


def _compare(name, got, want, dtype) -> float:
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite kernel output")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    tol = TOL[dtype]
    ok = bool(torch.allclose(g, w, **tol))
    log(f"# check {name}: max_abs_err {err!r} tol atol={tol['atol']} "
        f"rtol={tol['rtol']} {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with its plain version")
    return err


def _attn_within(got, want, floor: float = 0.0) -> tuple:
    """(max |got - want|, max |want|, ok) under the ATTN_STEP limit (plus
    ``floor``)."""
    g, w = got.float(), want.float()
    scale = float(w.abs().max()) if w.numel() else 0.0
    err = float((g - w).abs().max()) if g.numel() else 0.0
    ok = bool(((g - w).abs() <= ATTN_STEP * (scale + w.abs()) + floor).all())
    return err, scale, ok


def _compare_attn(name, got, want, dtype) -> float:
    """An attention output: TOL, and for bf16 also the ATTN_STEP limit."""
    err = _compare(name, got, want, dtype)
    if dtype == BF16:
        _, scale, ok = _attn_within(got, want)
        log(f"# check {name}: max_abs_err {err!r} max|plain| {scale!r} limit "
            f"{ATTN_STEP!r}*(max|plain|+|plain|) {'ok' if ok else 'FAIL'}")
        check(ok, f"{name}: kernel disagrees with its plain version (scaled limit)")
    return err


def _attn_limit_rejects(name, want, wrong) -> None:
    """Fail unless the ATTN_STEP limit tells ``wrong`` (a known kernel
    fault applied to the plain output) from ``want``."""
    err, scale, ok = _attn_within(wrong, want)
    log(f"# check {name}: max_abs_err {err!r} max|plain| {scale!r} "
        f"{'passes: FAIL' if ok else 'rejected: ok'}")
    check(not ok, f"{name}: the attention limit does not catch this fault")


def _compare_rel(name, got, want, dtype) -> float:
    """got vs want within GRAD_TOL[dtype] times max(1, max |want|)."""
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite kernel output")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    scale = float(w.abs().max()) if w.numel() else 0.0
    limit = GRAD_TOL[dtype] * max(1.0, scale)
    ok = err <= limit
    log(f"# check {name}: max_abs_err {err!r} max|plain| {scale!r} limit {limit!r} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with its plain version")
    return err


def phase_kernels() -> dict:
    """Kernel vs plain version on the card; returns the bf16 errors at the
    largest path shape of each kernel."""
    gen = torch.Generator(device=DEV).manual_seed(1)
    errs = {}
    for dtype in (BF16, F32):
        tag = "bf16" if dtype == BF16 else "fp32"
        for S in (1, 256, 260, 320, 384, 512, 1024):
            for masked in (True, False):
                q, k, v, bias, _ = _attn_inputs(8, S, dtype, gen, masked)
                err = _compare_attn(
                    f"attention {tag} B=8 S={S} {'mask' if masked else 'no-bias'}",
                    flash_attention_infer(q, k, v, bias),
                    flash_attention_infer_plain(q, k, v, bias), dtype)
                if dtype == BF16 and S == 512:
                    errs["flash_attention_infer"] = max(
                        errs.get("flash_attention_infer", 0.0), err)
        # BERT-base (gelu), the BigBird trunk (gelu_new), ProtBERT (H=1024),
        # at the edges of the 128-row tiles and at the paths' M
        for H, I, act in ((768, 3072, "gelu"), (768, 3072, "gelu_new"), (1024, 4096, "gelu")):
            for M in FFN_ROWS:
                args = _ffn_inputs(M, dtype, gen, H, I)
                err = _compare(
                    f"ffn_ln {tag} H={H} M={M} {act}",
                    fused_ffn_ln_block(*args, act=act),
                    fused_ffn_ln_block_plain(*args, act=act), dtype)
                if dtype == BF16 and M >= 24576:
                    errs["ffn_ln_block"] = max(errs.get("ffn_ln_block", 0.0), err)
                del args
        # ProtBERT's attention: S=3072, 16 heads, no mask
        q, k, v, _, _ = _attn_inputs(8, 3072, dtype, gen, masked=False, H=16)
        err = _compare_attn(f"attention {tag} B=8 S=3072 H=16 no-bias",
                       flash_attention_infer(q, k, v), flash_attention_infer_plain(q, k, v),
                       dtype)
        if dtype == BF16:
            errs["flash_attention_infer"] = max(errs["flash_attention_infer"], err)
    _attention_edges(gen)
    return errs


def _attention_edges(gen) -> None:
    """The bf16 kernel at the edges of its 128-row and 128-key tiles: S
    one under, at and one over 64 and 128, 200 and 3000; one head of one
    row and B=8 with 12 heads; masked and not, and masked with batch row
    0's keys all at -1e9 (a uniform softmax on both sides)."""
    for S in (63, 64, 65, 127, 128, 129, 200, 3000):
        for B, H in ((1, 1), (8, 12)):
            for masked in (True, False):
                q, k, v, bias, _ = _attn_inputs(B, S, BF16, gen, masked, H)
                label = f"attention bf16 edge B={B} H={H} S={S} {'mask' if masked else 'no-bias'}"
                want = flash_attention_infer_plain(q, k, v, bias)
                _compare_attn(label, flash_attention_infer(q, k, v, bias), want, BF16)
                if S == 3000 and B > 1 and not masked:
                    # the plain output with the second key tile left out
                    cut = torch.zeros(B, 1, 1, S, device=DEV)
                    cut[..., 128:256] = -1e9
                    _attn_limit_rejects(label + " without keys 128-255", want,
                                        flash_attention_infer_plain(q, k, v, cut))
                if masked and B > 1:
                    bias[0] = -1e9
                    _compare_attn(label + " row 0 all -1e9", flash_attention_infer(q, k, v, bias),
                                  flash_attention_infer_plain(q, k, v, bias), BF16)


def _train_attn_inputs(B, S, dtype, gen, masked=True, H=12, D=64):
    """q, k, v, bias, keep, a two-word seed and an output cotangent."""
    q, k, v, bias, keep = _attn_inputs(B, S, dtype, gen, masked, H, D)
    seed = torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32, generator=gen,
                         device=gen.device).cpu()
    do = torch.randn(B, S, H, D, generator=gen, device=gen.device).to(DEV, dtype)
    return q, k, v, bias, keep, seed, do


def _compare_grad(name, got, want, dtype) -> float:
    """An attention gradient: GRAD_TOL, and for bf16 also the ATTN_STEP
    limit."""
    err = _compare_rel(name, got, want, dtype)
    if dtype == BF16:
        _, scale, ok = _attn_within(got, want, GRAD_STEP_FLOOR)
        log(f"# check {name}: max_abs_err {err!r} max|plain| {scale!r} limit "
            f"{ATTN_STEP!r}*(max|plain|+|plain|)+{GRAD_STEP_FLOOR!r} {'ok' if ok else 'FAIL'}")
        check(ok, f"{name}: kernel disagrees with its plain version (scaled limit)")
    return err


def _attention_bwd_cases(tag, dtype, B, H, S, rate, gen, D=64) -> float:
    """The backward kernel against its plain version from the plain
    forward's out and lse: masked with db, masked without db, unmasked
    with db and, for B > 1, masked with batch row 0's keys all at -1e9;
    each call in bf16 past D = 256, and none other, on the dS pass and
    GEMMs of attention_bwd_wide_sm90.cuh (the library's count of its
    calls).  At the step's shape, bf16 and rate 0.1, it also shows that
    the bf16 gradient limits reject dK without its final scale and dV
    without the keep scale, and past D = 256 dQ from a dS pass without
    the keep scale on dP~.  Returns the worst gradient error."""
    worst = 0.0
    cases = [("mask db", True, True, False), ("mask no-db", True, False, False),
             ("no-bias db", False, True, False)]
    if B > 1:
        cases.append(("mask db row 0 all -1e9", True, True, True))
    for name, masked, need_db, dead_row in cases:
        q, k, v, bias, _, seed, do = _train_attn_inputs(B, S, dtype, gen, masked, H, D)
        if dead_row:
            bias[0] = -1e9
        out_p, lse_p = flash_attention_train_fwd_plain(q, k, v, bias, seed, rate)
        label = f"{tag} B={B} H={H} S={S}{'' if D == 64 else f' D={D}'} rate={rate} {name}"
        wide = dtype == BF16 and D > flash_attention_ops.MAX_INSTANCE_HEAD_DIM
        got = _route(f"attention bwd {label}", "the backward's dS pass and GEMMs",
                     flash_attention_ops.wide_backward_calls, int(wide),
                     lambda: flash_attention_train_bwd(q, k, v, bias, out_p, lse_p, do, seed,
                                                       rate, need_db=need_db))
        want = flash_attention_train_bwd_plain(q, k, v, bias, out_p, lse_p, do, seed, rate,
                                               need_db=need_db)
        for n, g, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
            worst = max(worst, _compare_grad(f"attention {n} {label}", g, w, dtype))
        check((got[3] is None) == (want[3] is None) == (not need_db), f"{label}: db presence")
        if need_db:
            worst = max(worst, _compare_rel(f"attention db {label}", got[3], want[3], F32))
        if dtype == BF16 and B > 1 and S == 512 and rate > 0 and name == "mask db":
            if D > 1:   # at D = 1 the scale is 1: there is none to lose
                _grad_limit_rejects(f"attention dk {label} without the scale", want[1],
                                    (want[1].float() * math.sqrt(D)).to(BF16))
            _grad_limit_rejects(f"attention dv {label} without the keep scale", want[2],
                                (want[2].float() * (1.0 - rate)).to(BF16))
            if wide:
                _grad_limit_rejects(f"attention dq {label} from a dS pass without the keep "
                                    f"scale on dP~", want[0],
                                    _dq_without_dp_keep_scale(q, k, v, bias, out_p, lse_p, do,
                                                              seed, rate))
        del q, k, v, bias, do, out_p, lse_p, got, want
    return worst


def _dq_without_dp_keep_scale(q, k, v, bias, out, lse, do, seed, rate):
    """The plain backward's dQ with a known fault: dP~ dropped by the hash
    but not scaled by 1/(1 - rate) before dS = p (dP - delta)."""
    B, S, H, D = q.shape
    f, scale = torch.float32, 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.reshape(B, 1, 1, S).float()
    p = torch.exp(s - lse[..., None])
    idx = torch.arange(S, device=q.device)
    keep = flash_attention_ops.dropout_keep_plain(
        seed, B, H, flash_attention_ops.padded_length(S), idx, idx, rate)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float()) * keep.to(f)
    delta = (do.float() * out.float()).sum(dim=-1).permute(0, 2, 1)[..., None]
    ds = (p * (dp - delta)).to(q.dtype).float()
    return (scale * torch.einsum("bhqk,bkhd->bqhd", ds, k.float())).to(q.dtype)


def _grad_limit_rejects(name, want, wrong) -> None:
    """Fail unless the bf16 gradient limits (GRAD_TOL and ATTN_STEP) tell
    ``wrong`` (a known kernel fault applied to the plain gradient) from
    ``want``; logs which of the two rejects it."""
    g, w = wrong.float(), want.float()
    err = float((g - w).abs().max())
    scale = float(w.abs().max())
    by_tol = err > GRAD_TOL[BF16] * max(1.0, scale)
    by_step = not _attn_within(wrong, want, GRAD_STEP_FLOOR)[2]
    log(f"# check {name}: max_abs_err {err!r} max|plain| {scale!r}; GRAD_TOL "
        f"{'rejects' if by_tol else 'passes'} it, ATTN_STEP {'rejects' if by_step else 'passes'} "
        f"it: {'ok' if by_tol or by_step else 'FAIL'}")
    check(by_tol or by_step, f"{name}: the gradient limits do not catch this fault")


def _train_ffn_inputs(M, dtype, gen, H=768, I=3072, fan_in=False):
    """x, w1, b1, w2, b2 (fp32 weights, as the model's parameters) and a
    cotangent g; the weights at std 0.02, or at 1/sqrt(fan-in) with
    ``fan_in`` (as :func:`_ffn_inputs`)."""
    def n(*shape, std=1.0):
        return (std * torch.randn(*shape, generator=gen, device=gen.device)).to(DEV)
    s1, s2 = (H ** -0.5, I ** -0.5) if fan_in else (0.02, 0.02)
    return (n(M, H).to(dtype), n(H, I, std=s1), n(I, std=0.02), n(I, H, std=s2),
            n(H, std=0.02), n(M, H).to(dtype))


def _train_ffn_cases(gen, note) -> None:
    """The training FFN pair against its plain versions: bf16 and fp32 at
    H=768, I=3072 at every M of TRAIN_FFN_ROWS with gelu and gelu_new;
    bf16 at I=992 (a ragged edge of the 128-column tiles, within the
    kernels' I % 32 == 0); ProtBERT's
    H=1024, I=4096 at M = 3 and 6,144.  At M=8,192 the bf16 dh limit must
    reject dh whose gelu' lacks its h-dependent term."""
    cases = [(dtype, 768, 3072, M, act) for dtype in (BF16, F32) for M in TRAIN_FFN_ROWS
             for act in ("gelu", "gelu_new")]
    cases += [(BF16, 768, 992, M, act) for M in (3, 129, 1000) for act in ("gelu", "gelu_new")]
    cases += [(dtype, 1024, 4096, M, "gelu") for dtype in (BF16, F32) for M in (3, 6144)]
    for dtype, H, I, M, act in cases:
        tag = "bf16" if dtype == BF16 else "fp32"
        x, w1, b1, w2, b2, g = _train_ffn_inputs(M, dtype, gen, H, I)
        label = f"{tag} H={H} I={I} M={M} {act}"
        e = _compare(f"ffn fwd {label}", fused_ffn_fwd(x, w1, b1, w2, b2, act=act),
                     fused_ffn_plain(x, w1, b1, w2, b2, act=act), dtype)
        note("ffn_train_fwd", e, dtype, (H, M) in ((768, 16384), (1024, 6144)))
        got = fused_ffn_bwd(x, g, w1, b1, w2, act=act)
        want = fused_ffn_bwd_plain(x, g, w1, b1, w2, act=act)
        e = max(_compare_rel(f"ffn dx {label}", got[0], want[0], dtype),
                _compare_rel(f"ffn dh {label}", got[1], want[1], dtype),
                _compare(f"ffn a {label}", got[2], want[2], dtype))
        note("ffn_train_bwd", e, dtype, (H, M) == (768, 16384))
        if dtype == BF16 and (H, I, M) == (768, 3072, 8192):
            _rel_limit_rejects(f"ffn dh {label} without the h-dependent term of gelu'",
                               want[1], _dh_without_h_term(x, g, w1, b1, w2, act))
        del x, w1, b1, w2, b2, g, got, want


def _dh_without_h_term(x, g, w1, b1, w2, act):
    """The plain version's dh with gelu' cut to its first term: 0.5 (1 +
    erf(h / sqrt 2)) without h phi(h), or 0.5 (1 + tanh(u)) without the
    tanh's derivative."""
    dt = x.dtype
    h = x.float() @ w1.to(dt).float() + b1.float()
    if act == "gelu":
        first = 0.5 * (1.0 + torch.erf(h * 2.0 ** -0.5))
    else:
        first = 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (h + 0.044715 * h ** 3)))
    return ((g.to(dt).float() @ w2.to(dt).float().T) * first).to(dt)


def _rel_limit_rejects(name, want, wrong) -> None:
    """Fail unless ``_compare_rel``'s limit (GRAD_TOL of max(1, max
    |want|)) tells ``wrong`` (a known kernel fault applied to the plain
    output) from ``want``."""
    g, w = wrong.float(), want.float()
    err = float((g - w).abs().max())
    limit = GRAD_TOL[want.dtype] * max(1.0, float(w.abs().max()))
    log(f"# check {name}: max_abs_err {err!r} limit {limit!r} "
        f"{'passes: FAIL' if err <= limit else 'rejected: ok'}")
    check(err > limit, f"{name}: the limit does not catch this fault")


def phase_train_kernels() -> dict:
    """The training kernels vs their plain versions on the card; returns,
    per kernel, the worst bf16 error at the step's largest shape."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    errs = {}

    def note(name, err, dtype, at_path_shape):
        if dtype == BF16 and at_path_shape:
            errs[name] = max(errs.get(name, 0.0), err)

    for dtype in (BF16, F32):
        tag = "bf16" if dtype == BF16 else "fp32"
        for S in (1, 260, 512, 1024):
            B = 4 if S == 1024 else 8
            for rate in (0.0, ATTN_RATE):
                q, k, v, bias, _, seed, _ = _train_attn_inputs(B, S, dtype, gen)
                label = f"{tag} B={B} S={S} rate={rate}"
                out, lse = flash_attention_train_fwd(q, k, v, bias, seed, rate)
                out_p, lse_p = flash_attention_train_fwd_plain(q, k, v, bias, seed, rate)
                e = max(_compare_attn(f"attention fwd {label}", out, out_p, dtype),
                        _compare(f"attention lse {label}", lse, lse_p, F32))
                note("flash_attention_train_fwd", e, dtype, S == 512)
        for S in ATTN_BWD_S:
            for B, H in ((1, 1), (TRAIN_BATCH, 12)):
                for rate in (0.0, ATTN_RATE):
                    e = _attention_bwd_cases(tag, dtype, B, H, S, rate, gen)
                    note("flash_attention_train_bwd", e, dtype, S == 512 and B > 1)
        # the forward across a 128-key tile (S=129) and with the TPU
        # kernel's padded keys (S=300, S_pad=512)
        for S in (129, 300):
            for rate in (0.0, ATTN_RATE):
                q, k, v, bias, _, seed, _ = _train_attn_inputs(8, S, dtype, gen)
                label = f"{tag} B=8 S={S} rate={rate}"
                out, lse = flash_attention_train_fwd(q, k, v, bias, seed, rate)
                out_p, lse_p = flash_attention_train_fwd_plain(q, k, v, bias, seed, rate)
                _compare_attn(f"attention fwd {label}", out, out_p, dtype)
                _compare(f"attention lse {label}", lse, lse_p, F32)
        # ProtBERT's attention in training: S=3072, 16 heads, rate 0.1 and 0
        for rate in (ATTN_RATE, 0.0):
            q, k, v, _, _, seed, _ = _train_attn_inputs(2, 3072, dtype, gen, False, H=16)
            out, lse = flash_attention_train_fwd(q, k, v, None, seed, rate)
            out_p, lse_p = flash_attention_train_fwd_plain(q, k, v, None, seed, rate)
            label = f"{tag} B=2 S=3072 H=16 rate={rate}"
            e = max(_compare_attn(f"attention fwd {label}", out, out_p, dtype),
                    _compare(f"attention lse {label}", lse, lse_p, F32))
            note("flash_attention_train_fwd", e, dtype, True)
            if dtype == BF16 and rate > 0:
                # the kept probabilities without their 1/(1-rate) scale
                _attn_limit_rejects(f"attention fwd {label} without the keep scale", out_p,
                                    (out_p.float() * (1.0 - rate)).to(BF16))
            del q, k, v, out, lse, out_p, lse_p
    _train_ffn_cases(gen, note)
    return errs


def _sparse_inputs(B, nb, dtype, gen, plan, padded, H=12, bs=64, D=64, r=3):
    """q, k, v (B, S, H, D) at S = nb * bs, a (B, S) mask, an (H, nb-2, r)
    plan on the card and an output cotangent for the middle rows.
    ``plan``: "eval" (all zeros) or "train" (HF's training plan at S=4096,
    else random legal blocks)."""
    S = nb * bs
    q, k, v = (torch.randn(B, S, H, D, generator=gen).to(DEV, dtype) for _ in range(3))
    mask = torch.ones(B, S)
    if padded:
        lengths = torch.randint(S // 2, S, (B,), generator=gen)
        mask = (torch.arange(S)[None, :] < lengths[:, None]).float()
    if plan == "eval":
        rand = torch.zeros(H, nb - 2, r, dtype=torch.int32)
    elif S == 4096:
        rand = torch.as_tensor(build_rand_attn(S, bs, r, H, 1, S, training=True)[0])
    else:
        rand = torch.randint(1, nb - 1, (H, nb - 2, r), generator=gen, dtype=torch.int32)
    do = torch.randn(B, (nb - 2) * bs, H, D, generator=gen).to(DEV, dtype)
    return q, k, v, mask.to(DEV), rand.to(DEV), do


# (B, nb, padded mask) of the sparse pair's checks at each block size: the
# smallest block-sparse S (nb=5), a padded mask (nb=8) and the trunk's
# S=4096, at B=2 (forward and backward) and B=8 (forward)
SPARSE_CASES = {64: ((2, 5, False), (2, 8, True), (2, 64, False), (8, 64, True)),
                128: ((2, 5, False), (2, 8, True), (2, 32, False), (8, 32, True))}


def phase_sparse_kernels() -> dict:
    """The BigBird kernel pair vs its plain versions on the card, bf16 and
    fp32, at block sizes 64 and 128 (``SPARSE_CASES``), with the eval and
    the training plan; bf16 contexts and gradients also under the
    elementwise limits, which must reject three faults at S=4096, at each
    block size (``_sparse_limits_reject``).  The other head widths and
    block sizes are phase 27's.  Returns, per kernel, the worst bf16 error
    at S=4096 over both block sizes."""
    gen = torch.Generator().manual_seed(6)
    errs = {}
    for bs, cases in SPARSE_CASES.items():
        for dtype in (BF16, F32):
            tag = "bf16" if dtype == BF16 else "fp32"
            for B, nb, padded in cases:
                for plan in ("eval", "train"):
                    q, k, v, mask, rand, do = _sparse_inputs(B, nb, dtype, gen, plan, padded,
                                                             bs=bs)
                    label = (f"{tag} bs={bs} B={B} S={nb * bs} {plan} plan"
                             f"{' mask' if padded else ''}")
                    out, lse = bigbird_mid_fwd(q, k, v, mask, rand, bs)
                    out_p, lse_p = bigbird_mid_fwd_plain(q, k, v, mask, rand, bs)
                    e = max(_compare_attn(f"sparse fwd {label}", out, out_p, dtype),
                            _compare(f"sparse lse {label}", lse, lse_p, dtype))
                    if dtype == BF16 and nb * bs == 4096:
                        errs["bigbird_mid_fwd"] = max(errs.get("bigbird_mid_fwd", 0.0), e)
                    if B == 2:
                        got = bigbird_mid_bwd(q, k, v, mask, rand, bs, out_p, lse_p, do)
                        want = bigbird_mid_bwd_plain(q, k, v, mask, rand, bs, out_p, lse_p, do)
                        e = max(_compare_grad(f"sparse {n} {label}", g, w, dtype)
                                for n, g, w in zip(("dq", "dk", "dv"), got, want))
                        if dtype == BF16 and nb * bs == 4096:
                            errs["bigbird_mid_bwd"] = max(errs.get("bigbird_mid_bwd", 0.0), e)
                        if dtype == BF16 and nb * bs == 4096 and plan == "train":
                            _sparse_limits_reject(label, q, k, v, mask, rand, out_p, lse_p, do,
                                                  want[1], bs)
                        del got, want
                    del q, k, v, out, lse, out_p, lse_p
    return errs


# (block size, head width, S) outside the pair's domain: S not a multiple
# of the block size, 4 blocks, block size 0, head width 0 (any block size
# and head width from 1 with at least 5 blocks is inside); and the C entry
# points' own refusals, which take head widths that are multiples of 8
# (the wrappers pad others): the same, and D = 4 and 36
SPARSE_OUTSIDE = ((25, 32, 210), (25, 32, 100), (0, 32, 320), (64, 0, 320))
SPARSE_C_OUTSIDE = SPARSE_OUTSIDE + ((64, 4, 320), (64, 36, 320))
# a logit scale that is 1/sqrt(d) of no head width d from 1 to 64 in bf16
SPARSE_BAD_SCALE = 0.9


def _sparse_geometry_rejected(gen) -> None:
    """A CUDA tensor outside the pair's domain (``SPARSE_OUTSIDE``) raises
    in both wrappers, in both dtypes, and launches nothing; the C entry
    points refuse such a geometry themselves (cudaErrorInvalidValue, 1)
    without a launch (``SPARSE_C_OUTSIDE``), and in bf16 a logit scale
    that is 1/sqrt(d) of no head width d the padding to D may hide
    (``SPARSE_BAD_SCALE``)."""
    fwd0, bwd0 = bigbird_mid_fwd.launches, bigbird_mid_bwd.launches
    said = ("takes any D and block size from 1", "not a multiple of the block size",
            "at least 5 blocks", "block size must be at least 1")
    for dtype in (BF16, F32):
        for bs, D, S in SPARSE_OUTSIDE:
            n = max(S - 2 * bs, 1)
            q, k, v = (torch.randn(1, S, 1, D, generator=gen).to(DEV, dtype) for _ in range(3))
            mask = torch.ones(1, S, device=DEV)
            rand = torch.ones(1, max(S // max(bs, 1) - 2, 1), 1, dtype=torch.int32, device=DEV)
            out = torch.zeros(1, n, 1, D, dtype=dtype, device=DEV)
            lse = torch.zeros(1, 1, n, device=DEV)
            for name, call in (("fwd", lambda: bigbird_mid_fwd(q, k, v, mask, rand, bs)),
                               ("bwd", lambda: bigbird_mid_bwd(q, k, v, mask, rand, bs, out, lse,
                                                               out))):
                raised = _refused(name, call)
                log(f"# check sparse {name} {dtype} bs={bs} D={D} S={S} raises: {raised!r}")
                check(any(x in raised for x in said),
                      f"sparse {name} took block size {bs}, head width {D}, S={S} on the card")
    check((bigbird_mid_fwd.launches, bigbird_mid_bwd.launches) == (fwd0, bwd0),
          "a refused geometry counted a launch")
    lib = _build.load("bigbird_sparse", bigbird_sparse_ops._SIGNATURES)
    buf = torch.zeros(1 << 20, device=DEV)
    p, st = _build.ptr(buf), _build.stream(buf.device)
    for dt in (1, 0):
        for bs, D, S in SPARSE_C_OUTSIDE:
            scale = max(D, 1) ** -0.5
            statuses = {
                "bigbird_mid_fwd": lib.bigbird_mid_fwd(dt, *[p] * 8, 1, S, 1, 1, bs, D, S * D,
                                                       D, D, scale, st),
                "bigbird_mid_bwd": lib.bigbird_mid_bwd(dt, *[p] * 11, 1, S, 1, 1, bs, D, S * D,
                                                       D, D, scale, st)}
            torch.cuda.synchronize()
            for name, status in statuses.items():
                log(f"# check {name} C entry point dtype {dt} at bs={bs} D={D} S={S}: status "
                    f"{status} (1: refused)")
                check(status == 1, f"the C entry point {name} took bs={bs} D={D} S={S} "
                                   f"(status {status})")
    for D in (8, 16, 32, 40, 64, 128):
        S = 5 * 64
        bad = SPARSE_BAD_SCALE
        statuses = {
            "bigbird_mid_fwd": lib.bigbird_mid_fwd(1, *[p] * 8, 1, S, 1, 1, 64, D, S * D, D, D,
                                                   bad, st),
            "bigbird_mid_bwd": lib.bigbird_mid_bwd(1, *[p] * 11, 1, S, 1, 1, 64, D, S * D, D, D,
                                                   bad, st)}
        torch.cuda.synchronize()
        for name, status in statuses.items():
            log(f"# check {name} C entry point bf16 at D={D} with logit scale {bad}: status "
                f"{status} (1: refused)")
            check(status == 1, f"the C entry point {name} took scale {bad} at D={D} in bf16")


def _sparse_fwd_with(q, k, v, rand, bs, pen_of):
    """The plain forward's context with the slot penalties (B, H, n, 1, W)
    replaced by ``pen_of(pen, gathered mask)``: a known fault applied to
    the plain version."""
    B, S, H, D = q.shape
    qm, kc, vc, pen, idx = _mid_operands(q, k, v, torch.ones(B, S, device=q.device), rand, bs)
    logits = _mid_logits(qm, kc, pen_of(pen, idx), q.dtype)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhjqk,bhjkd->bhjqd", w.float(), vc.float()).to(q.dtype)
    return ctx.permute(0, 2, 3, 1, 4).reshape(B, -1, H, D)


def _sparse_limits_reject(label, q, k, v, mask, rand, out, lse, do, dk, bs) -> None:
    """At S=4096 (bf16, the training plan, no padding, block size ``bs``),
    the limits the pair is held to must reject: a context without the
    first random slot, a context where the duplicate window slot (block 0
    at query block 1, block nb-1 at query block nb-2) keeps its keys, and
    dK without the g0 slot's adds."""
    check(bool((mask == 1).all()), "the fault checks take an unpadded mask")
    want = bigbird_mid_fwd_plain(q, k, v, mask, rand, bs)[0]

    def no_random_slot(pen, idx):
        pen = pen.clone()
        pen[..., 5 * bs:6 * bs] = -math.inf
        return pen

    def no_dup_penalty(pen, idx):
        return torch.zeros_like(pen)   # an unpadded mask: only the duplicate slots had one

    _attn_limit_rejects(f"sparse fwd {label} without one random slot", want,
                        _sparse_fwd_with(q, k, v, rand, bs, no_random_slot))
    _attn_limit_rejects(f"sparse fwd {label} without the duplicate slot's penalty", want,
                        _sparse_fwd_with(q, k, v, rand, bs, no_dup_penalty))
    # dK less the g0 slot's adds: sum over the middle query blocks of its
    # dS^T q, taken from block 0's rows
    B, S, H, D = q.shape
    qm, kc, _, pen, _ = _mid_operands(q, k, v, mask, rand, bs)
    f = torch.float32
    p = torch.exp(_mid_logits(qm, kc, pen, q.dtype) - lse.reshape(B, H, -1, bs, 1))
    do_b, o_b = (_blocked(t, bs).float() for t in (do, out))
    vg = _blocked(v, bs)[:, :, 0].float()   # block 0's values (the g0 slot)
    dp = torch.einsum("bhjqd,bhkd->bhjqk", do_b, vg)
    row = (do_b * o_b).sum(dim=-1, keepdim=True)
    ds = p[..., :bs] * (dp - row) / math.sqrt(D)
    dk_g0 = torch.einsum("bhjqk,bhjqd->bhkd", ds, qm.to(f))   # (B, H, bs, D)
    wrong = dk.float().clone()
    wrong[:, :bs] -= dk_g0.permute(0, 2, 1, 3)
    _grad_limit_rejects(f"sparse dk {label} without the g0 slot's adds", dk, wrong.to(dk.dtype))


def _features(cfg: STonKGsConfig, n: int, seed: int = 0) -> dict:
    """Synthetic rows whose true text lengths are drawn from 10 to 256."""
    rng = np.random.default_rng(seed)
    tl, el = cfg.text_len, cfg.entity_len
    lengths = rng.integers(10, tl + 1, n)
    keep = np.arange(tl)[None, :] < lengths[:, None]
    text = np.where(keep, rng.integers(4, cfg.bert.vocab_size, (n, tl)), 0)
    ent = rng.integers(0, cfg.kg_vocab_size, (n, el))
    return {
        "input_ids": np.concatenate([text, ent], 1).astype(np.int64),
        "attention_mask": np.concatenate(
            [keep.astype(np.int64), np.ones((n, el), np.int64)], 1),
        "token_type_ids": np.concatenate(
            [np.zeros((n, tl), np.int64), np.ones((n, el), np.int64)], 1),
    }


SERVING_KERNELS = {"ffn_ln_block": fused_ffn_ln_block,
                   "flash_attention_infer": flash_attention_infer}
TRAINING_KERNELS = {"flash_attention_train_fwd": flash_attention_train_fwd,
                    "flash_attention_train_bwd": flash_attention_train_bwd,
                    "ffn_train_fwd": fused_ffn_fwd,
                    "ffn_train_bwd": fused_ffn_bwd}


def _reset_counts(kernels: dict) -> None:
    for fn in kernels.values():
        fn.launches = 0


def _counts(kernels: dict) -> dict:
    return {name: fn.launches for name, fn in kernels.items()}


def _cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _stonkgs_params(cfg: STonKGsConfig, seed: int = 0) -> dict:
    """Seeded random STonKGs parameters, fp32 on the CPU, with the KG
    table's special rows from the backbone run on the card in bf16."""
    gen = torch.Generator().manual_seed(seed)
    params = stonkgs.init_stonkgs_params(gen, cfg)
    kg_vectors = torch.randn(cfg.kg_vocab_size, cfg.bert.hidden_size,
                             generator=gen).numpy()
    lm = params_to(params["lm_backbone"], DEV, BF16)
    params["kg_backbone"] = stonkgs.build_kg_table(lm, cfg.bert, kg_vectors,
                                                   compute_dtype=BF16).cpu()
    check(bool(torch.isfinite(params["kg_backbone"]).all()), "KG table not finite")
    return params


def phase_serving(cfg: STonKGsConfig):
    """Serving through STonKGsEngine; returns what phase 5 times and the
    main path's launch counts."""
    t0 = time.perf_counter()
    params = _stonkgs_params(cfg)
    params_bf16 = params_to(params, DEV, BF16)
    log(f"# serving setup (init + KG table): {time.perf_counter() - t0:.1f} s")

    feats = _features(cfg, ROWS)
    engine = STonKGsEngine(cfg=cfg, params=params_bf16, batch_size=BATCH, device=DEV)
    bucketed = STonKGsEngine(cfg=cfg, params=params_bf16, batch_size=BATCH,
                             length_buckets=BUCKETS, device=DEV)

    # the main path: parity-mode embed, counts from 0 just before it
    _reset_counts(SERVING_KERNELS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = engine.embed(feats)
    first = time.perf_counter() - t1
    counts = _counts(SERVING_KERNELS)
    n_batches = math.ceil(ROWS / BATCH)
    per_batch = cfg.bert.num_hidden_layers * 2 - 1   # backbone 12 + trunk 11
    log(f"# launches parity embed ({n_batches} batches): {counts}")
    check(out.shape == (ROWS, cfg.bert.hidden_size), f"embed shape {out.shape}")
    check(bool(np.isfinite(out).all()), "embed output not finite")
    for name, c in counts.items():
        check(c == per_batch * n_batches,
              f"{name}: {c} launches, expected {per_batch} x {n_batches}")

    _reset_counts(SERVING_KERNELS)
    out_b = bucketed.embed(feats)
    counts_b = _counts(SERVING_KERNELS)
    log(f"# launches bucketed embed: {counts_b}")
    check(out_b.shape == out.shape and bool(np.isfinite(out_b).all()),
          "bucketed embed output wrong")
    check(all(c > 0 for c in counts_b.values()), "bucketed embed skipped a kernel")

    # numerics: card fp32 vs CPU fp32, card bf16 vs CPU fp32, on 4 rows
    few = {k: v[:4] for k, v in feats.items()}
    card32 = STonKGsEngine(cfg=cfg, params=params, compute_dtype="float32",
                           batch_size=4, device=DEV).embed(few)
    cpu32 = STonKGsEngine(cfg=cfg, params=params, compute_dtype="float32",
                          batch_size=4, device="cpu").embed(few)
    err32 = float(np.abs(card32 - cpu32).max())
    cos = _cosine(out[:4], cpu32)
    log(f"# card fp32 vs CPU fp32 (4 rows): max_abs_err {err32!r} (limit 1e-3)")
    log(f"# card bf16 vs CPU fp32 (4 rows): cosine {cos.tolist()!r} (limit 0.99)")
    check(err32 <= 1e-3, "card fp32 disagrees with the CPU")
    check(bool((cos >= 0.99).all()), "card bf16 too far from the CPU fp32")
    cos_b = _cosine(out_b, out)
    log(f"# bucketed vs parity (bf16, {ROWS} rows): min cosine {float(cos_b.min())!r}")
    return engine, bucketed, feats, counts, params


_time_ms = functools.partial(time_ms, iters=10)


def _bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def _time_ffn(label: str, M: int, gen, H=768, I=3072, act="gelu") -> dict:
    """Kernel vs plain at the main path's shape, then both timed, and the
    two cuBLAS bf16 products the block contains (x @ W1, h @ W2) alone, a
    yardstick only: no one PyTorch call computes the block."""
    args = _ffn_inputs(M, BF16, gen, H, I)
    flops = 4.0 * M * H * I
    nbytes = (3 * M * H + 2 * H * I) * 2 + (5 * H + I) * 4
    bound, by = _bound_ms(flops, nbytes, BF16)
    err = _compare(f"ffn_ln bf16 {label}", fused_ffn_ln_block(*args, act=act),
                   fused_ffn_ln_block_plain(*args, act=act), BF16)
    x, w1, w2 = args[0], args[4], args[6]
    h = x @ w1
    t = dict(max_abs_err=err,
             ms=_time_ms(lambda: fused_ffn_ln_block(*args, act=act)),
             plain_ms=_time_ms(lambda: fused_ffn_ln_block_plain(*args, act=act), iters=3),
             bound_ms=bound, bound_by=by, library_ms=None,
             cublas_gemms_ms=_time_ms(lambda: x @ w1) + _time_ms(lambda: h @ w2))
    log(f"# rate ffn_ln_block {label}: {flops / (t['ms'] * 1e-3) / 1e12!r} TFLOP/s at "
        f"{flops:.4g} flops; {t['ms'] / t['cublas_gemms_ms']!r} x the two cuBLAS products")
    return t


def _time_attention(label: str, B: int, S: int, masked: bool, gen, H=12, D=64) -> dict:
    """Kernel vs plain at the main path's shape, then both and SDPA timed."""
    q, k, v, bias, keep = _attn_inputs(B, S, BF16, gen, masked, H, D)
    H, D = q.shape[2], q.shape[3]
    flops = 4.0 * B * H * S * S * D
    nbytes = 4 * B * S * H * D * 2 + (B * S * 4 if masked else 0)
    bound, by = _bound_ms(flops, nbytes, BF16)
    err = _compare_attn(f"attention bf16 {label}", flash_attention_infer(q, k, v, bias),
                        flash_attention_infer_plain(q, k, v, bias), BF16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # views, no copy
    mask = None if keep is None else keep[:, None, None, :]
    t = dict(max_abs_err=err,
             ms=_time_ms(lambda: flash_attention_infer(q, k, v, bias)),
             plain_ms=_time_ms(lambda: flash_attention_infer_plain(q, k, v, bias), iters=3),
             bound_ms=bound, bound_by=by,
             library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, attn_mask=mask)))
    _log_attention_rate(f"flash_attention_infer {label}", flops, t)
    return t


def _log_attention_rate(label: str, flops: float, t: dict) -> None:
    """The kernel's TFLOP/s at the counted products and its time as a
    multiple of SDPA's."""
    log(f"# rate {label}: {flops / (t['ms'] * 1e-3) / 1e12!r} TFLOP/s at "
        f"{flops:.4g} flops; {t['ms'] / t['library_ms']!r} x SDPA")


def phase_timing(cfg: STonKGsConfig, engine, bucketed, feats) -> dict:
    """Embed throughput, then each kernel at the main path's shapes (held
    against its plain version there, then timed); returns, per kernel, the
    trunk shape's numbers with the worse error of the two shapes."""
    for label, eng in (("parity", engine), ("bucketed", bucketed)):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eng.embed(feats)
            times.append(time.perf_counter() - t0)
        check(bool(np.isfinite(out).all()), f"{label} embed not finite")
        n = len(out)
        log(f"# embed {label}: {n} rows, B={BATCH}, seconds {times!r}; "
            f"best {n / min(times)!r} pairs/s, median "
            f"{n / statistics.median(times)!r} pairs/s")
    gen = torch.Generator(device=DEV).manual_seed(2)
    tl, sl = cfg.text_len, cfg.seq_len
    shapes = {
        "ffn_ln_block": [(f"trunk M={BATCH * sl}", _time_ffn, (BATCH * sl,)),
                         (f"backbone M={BATCH * tl}", _time_ffn, (BATCH * tl,))],
        "flash_attention_infer": [
            (f"trunk B={BATCH} S={sl} mask", _time_attention, (BATCH, sl, True)),
            (f"backbone B={BATCH} S={tl} no-bias", _time_attention, (BATCH, tl, False))],
    }
    result = {}
    for name, cases in shapes.items():
        for i, (label, fn, args) in enumerate(cases):
            t = fn(label, *args, gen)
            log(f"# time {name} {label} bf16: {json.dumps(t)}")
            if i == 0:
                result[name] = t   # the trunk shape goes into the kernel line
            else:
                result[name + ":backbone"] = t
                result[name]["max_abs_err"] = max(result[name]["max_abs_err"],
                                                  t["max_abs_err"])
    # a parity batch's kernel time from these per-call times
    layers = cfg.bert.num_hidden_layers
    kern = (layers * result["ffn_ln_block:backbone"]["ms"]
            + (layers - 1) * result["ffn_ln_block"]["ms"]
            + layers * result["flash_attention_infer:backbone"]["ms"]
            + (layers - 1) * result["flash_attention_infer"]["ms"])
    log(f"# kernel time per parity batch of {BATCH} ({layers} backbone + "
        f"{layers - 1} trunk layers, from the per-call times): {kern!r} ms")
    return result


def _pretraining_features(cfg: STonKGsConfig, n: int, seed: int = 0) -> dict:
    """Synthetic pre-training rows as ``benchmarks/_util.py`` builds them:
    uniform tokens and entities, exactly int(0.15 * len) masked positions
    per half, random NSP labels."""
    rng = np.random.default_rng(seed)
    tl, el = cfg.text_len, cfg.entity_len
    text = rng.integers(0, cfg.bert.vocab_size, (n, tl))
    ent = rng.integers(0, cfg.kg_vocab_size, (n, el))
    mlm = np.full((n, tl), -100, np.int64)
    elm = np.full((n, el), -100, np.int64)
    k_text, k_ent = int(tl * 0.15), int(el * 0.15)
    for i in range(n):
        mlm[i, rng.choice(tl, k_text, replace=False)] = rng.integers(
            0, cfg.bert.vocab_size, k_text)
        elm[i, rng.choice(el, k_ent, replace=False)] = rng.integers(
            0, cfg.kg_vocab_size, k_ent)
    return {
        "input_ids": np.concatenate([text, ent], 1).astype(np.int64),
        "attention_mask": np.ones((n, tl + el), np.int64),
        "token_type_ids": np.concatenate(
            [np.zeros((n, tl), np.int64), np.ones((n, el), np.int64)], 1),
        "masked_lm_labels": mlm,
        "ent_masked_lm_labels": elm,
        "next_sentence_labels": rng.integers(0, 2, (n,)).astype(np.int64),
    }


def phase_training(cfg: STonKGsConfig, params_cpu: dict):
    """``pretrain`` at full width on the card: the main training path,
    counts from 0 just before it.  Returns its launch counts and state."""
    t0 = time.perf_counter()
    params = params_to(params_cpu, DEV)   # fp32 parameters on the card
    frozen_before = tree_map(lambda t: t.clone(), split_frozen(params)[1])
    feats = _pretraining_features(cfg, TRAIN_BATCH * TRAIN_STEPS)
    run_cfg = pretraining.PretrainingConfig(
        max_steps=TRAIN_STEPS, micro_batch_size=TRAIN_BATCH, log_steps=1,
        compute_dtype="bfloat16")
    logged = []
    log(f"# training setup: {time.perf_counter() - t0:.1f} s")
    _reset_counts(TRAINING_KERNELS)
    state = pretraining.pretrain(cfg, params, feats, run_cfg,
                                 log_fn=lambda step, m: logged.append((step, m)))
    torch.cuda.synchronize()
    counts = _counts(TRAINING_KERNELS)
    layers = cfg.bert.num_hidden_layers
    log(f"# launches pretrain ({TRAIN_STEPS} steps, B={TRAIN_BATCH}): {counts}")
    expected = {"flash_attention_train_fwd": 2 * layers, "flash_attention_train_bwd": layers,
                "ffn_train_fwd": 2 * layers, "ffn_train_bwd": layers}
    for name, per_step in expected.items():
        check(counts[name] == per_step * TRAIN_STEPS,
              f"{name}: {counts[name]} launches, expected {per_step} x {TRAIN_STEPS}")
    for step, m in logged:
        log(f"# pretrain step {step}: " + json.dumps(m))
    check([s for s, _ in logged] == list(range(1, TRAIN_STEPS + 1)),
          f"pretrain logged steps {[s for s, _ in logged]}")
    check(all(math.isfinite(m["loss"]) for _, m in logged), "non-finite pretraining loss")
    frozen_after = split_frozen(state.params)[1]
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(frozen_before),
                                                tree_leaves(frozen_after))),
          "a frozen backbone changed")
    before, after = tree_flatten_with_path(split_frozen(params)[0]), tree_flatten_with_path(state.params)
    unchanged = [k for k in before if torch.equal(before[k], after[k])]
    log(f"# trainable leaves unchanged after {TRAIN_STEPS} steps: {unchanged}")
    check(set(unchanged) <= set(UNUSED_LEAVES), "a trainable leaf did not change")
    return counts, state


# trainable leaves that take no part in the pre-training loss, in both
# packages: the trunk reads backbone embeddings, not its word embeddings,
# and the ELM decoder biases are never applied (the reference's quirk)
UNUSED_LEAVES = ("trunk/embeddings/word_embeddings", "cls/predictions/text_bias",
                 "cls/predictions/entity_bias")


# trunk leaves whose gradient is zero in exact arithmetic: a key bias
# adds the same q . b_k to every score of a query row, which the softmax
# cancels; both sides hold it at the rounding level, where a cosine means
# nothing
ZERO_GRAD_LEAVES = ("attention/key/bias",)


def phase_train_numerics(cfg_full: STonKGsConfig) -> None:
    """Loss and trunk gradients at 2 rows and 2 layers of the full width,
    hidden dropout 0 and attention dropout 0.1 (the attention seeds come
    from the same CPU generator on both sides), against the CPU in fp32:
    the card in fp32 (the SIMT bodies), then the card in bf16 (the Hopper
    kernels), each leaf by its cosine."""
    bcfg = dataclasses.replace(cfg_full.bert, num_hidden_layers=2, hidden_dropout_prob=0.0)
    cfg = cfg_full.replace(bert=bcfg)
    gen = torch.Generator().manual_seed(5)
    params = stonkgs.init_stonkgs_params(gen, cfg)
    params["kg_backbone"] = torch.randn(cfg.kg_table_size, bcfg.hidden_size, generator=gen)
    feats = _pretraining_features(cfg, 2, seed=7)

    def loss_and_grads(device, dtype=F32):
        p = params_to(params, device)
        named = tree_flatten_with_path(p["trunk"])
        for t in named.values():
            t.requires_grad_(True)
        loss, _ = stonkgs.pretraining_loss(
            p, cfg, pretraining.to_device(feats, device), deterministic=False,
            rng=pretraining.step_rng(0, 0, device), compute_dtype=dtype)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        for t in named.values():
            t.requires_grad_(False)
        # the trunk's word embeddings take no part (it reads the backbones')
        return float(loss.detach()), {n: g.detach().cpu() for n, g in zip(named, grads)
                                      if g is not None}

    launches = flash_attention_train_fwd.launches
    loss_card, g_card = loss_and_grads(DEV)
    check(flash_attention_train_fwd.launches > launches, "the card run launched no kernel")
    loss_cpu, g_cpu = loss_and_grads("cpu")
    check(g_card.keys() == g_cpu.keys(), "card and CPU differ in their gradient leaves")
    err = max(float((g_card[n] - g_cpu[n]).abs().max()) for n in g_cpu)
    scale = max(float(g.abs().max()) for g in g_cpu.values())
    log(f"# train card fp32 vs CPU fp32 (2 rows, 2 layers, attention dropout "
        f"{ATTN_RATE}): loss {loss_card!r} vs {loss_cpu!r}; trunk grads max_abs_err "
        f"{err!r} of max |grad| {scale!r} (limits: loss 1e-4 relative, grads 1e-3 of "
        f"max |grad|)")
    check(abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu), "card loss disagrees with the CPU")
    check(err <= 1e-3 * scale, "card gradients disagree with the CPU")

    # bf16 compute on the card: every FFN of the 2 trunk and 2 backbone
    # layers through the Hopper pair
    before = (fused_ffn_fwd.launches, fused_ffn_bwd.launches)
    loss_bf16, g_bf16 = loss_and_grads(DEV, BF16)
    check(fused_ffn_fwd.launches - before[0] == 4 and fused_ffn_bwd.launches - before[1] == 2,
          f"bf16 numerics launched the FFN pair {fused_ffn_fwd.launches - before[0]} / "
          f"{fused_ffn_bwd.launches - before[1]} times, expected 4 / 2")
    check(g_bf16.keys() == g_cpu.keys(), "card bf16 and CPU differ in their gradient leaves")
    norm_max = max(float(g.norm()) for g in g_cpu.values())
    cosines = {}
    for n, want in g_cpu.items():
        got = g_bf16[n].double().flatten()
        w = want.double().flatten()
        if n.endswith(ZERO_GRAD_LEAVES):
            check(float(w.norm()) <= 1e-6 * norm_max and float(got.norm()) <= 1e-4 * norm_max,
                  f"{n}: a gradient that should cancel reads {float(w.norm())!r} (CPU), "
                  f"{float(got.norm())!r} (card bf16) of the largest leaf norm {norm_max!r}")
            continue
        cosines[n] = float(got @ w / (got.norm() * w.norm()))
    worst = min(cosines, key=cosines.get)
    rel = abs(loss_bf16 - loss_cpu) / abs(loss_cpu)
    log(f"# train card bf16 vs CPU fp32 (same rows and seeds): loss {loss_bf16!r} vs "
        f"{loss_cpu!r} ({rel!r} relative; limit 1e-2); {len(cosines)} trunk gradient leaves, "
        f"lowest cosine {cosines[worst]!r} ({worst}; limit 0.99); mean "
        f"{statistics.fmean(cosines.values())!r}; {ZERO_GRAD_LEAVES} at the rounding level "
        f"on both sides")
    check(rel <= 1e-2, "card bf16 loss disagrees with the CPU")
    check(cosines[worst] >= 0.99, f"card bf16 gradient {worst} disagrees with the CPU")


def _time_train_attention(label, B, S, masked, gen, backward, H=12, D=64) -> dict:
    """A training attention kernel vs plain at the step's shape, then both
    and the library call (SDPA without dropout, which cannot draw the
    hash mask) timed."""
    q, k, v, bias, keep, seed, do = _train_attn_inputs(B, S, BF16, gen, masked, H, D)
    H, D = q.shape[2], q.shape[3]
    io = B * S * H * D * 2   # one (B, S, H, D) bf16 tensor
    stats = B * H * S * 4    # lse (and, backward, delta is scratch: not counted)
    kb = B * S * 4 if masked else 0
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None if keep is None else keep[:, None, None, :]
    flops = (10.0 if backward else 4.0) * B * H * S * S * D
    if not backward:
        bound, by = _bound_ms(flops, 4 * io + stats + kb, BF16)
        fn = lambda: flash_attention_train_fwd(q, k, v, bias, seed, ATTN_RATE)  # noqa: E731
        plain = lambda: flash_attention_train_fwd_plain(q, k, v, bias, seed, ATTN_RATE)  # noqa: E731
        err = _compare_attn(f"attention fwd bf16 {label}", fn()[0], plain()[0], BF16)
        lib = _time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    else:
        out, lse = flash_attention_train_fwd(q, k, v, bias, seed, ATTN_RATE)
        # the path's bias takes no gradient: no db
        bound, by = _bound_ms(flops, 8 * io + stats + kb, BF16)
        fn = lambda: flash_attention_train_bwd(  # noqa: E731
            q, k, v, bias, out, lse, do, seed, ATTN_RATE, need_db=False)
        plain = lambda: flash_attention_train_bwd_plain(  # noqa: E731
            q, k, v, bias, out, lse, do, seed, ATTN_RATE, need_db=False)
        err = max(_compare_grad(f"attention {n} bf16 {label}", g, w, BF16)
                  for n, g, w in zip(("dq", "dk", "dv"), fn()[:3], plain()[:3]))
        lib = _time_sdpa_backward(label, qt, kt, vt, mask, do.transpose(1, 2))
    t = dict(max_abs_err=err, ms=_time_ms(fn), plain_ms=_time_ms(plain, iters=3),
             bound_ms=bound, bound_by=by, library_ms=lib)
    _log_attention_rate(f"flash_attention_train_{'bwd' if backward else 'fwd'} {label}", flops,
                        t)
    return t


def _time_sdpa_backward(label, q, k, v, mask, dout) -> float:
    """SDPA's backward alone: one forward with inputs that require grad,
    then ``torch.autograd.grad`` over that saved graph, timed; logs the
    backend that ran and its kernels' device time (from three traced
    backwards: the timed call also carries autograd's host work)."""
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)

    def backward():
        return torch.autograd.grad(o, (qg, kg, vg), dout, retain_graph=True)
    backward()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            backward()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    names = sorted(e.key for e in events)
    device_ms = sum(e.self_device_time_total for e in events) / 3 / 1e3
    low = " ".join(names).lower()
    backend = ("cudnn" if "cudnn" in low else "flash" if "flash" in low
               else "efficient" if ("fmha" in low or "efficient" in low) else "math")
    ms = _time_ms(backward)
    log(f"# SDPA backward {label}: {ms!r} ms a call alone over a saved forward, "
        f"{device_ms!r} ms of it on the device, backend {backend}; kernels {names}")
    return ms


def _time_train_ffn(label, M, gen, backward, H=768, I=3072, act="gelu") -> dict:
    """A training FFN kernel vs plain at the path's shape, then both timed,
    and the cuBLAS bf16 products the kernel contains timed alone (x W1 + h
    W2 forward; x W1 + g W2^T + dh W1^T backward), a yardstick only: no
    one PyTorch call computes the fused function."""
    x, w1, b1, w2, b2, g = _train_ffn_inputs(M, BF16, gen, H, I)
    w1b, w2b = w1.to(BF16), w2.to(BF16)
    if not backward:
        flops = 4.0 * M * H * I
        bound, by = _bound_ms(flops, 2 * M * H * 2 + 2 * H * I * 2 + (H + I) * 4, BF16)
        fn = lambda: fused_ffn_fwd(x, w1, b1, w2, b2, act=act)  # noqa: E731
        plain = lambda: fused_ffn_plain(x, w1, b1, w2, b2, act=act)  # noqa: E731
        err = _compare(f"ffn fwd bf16 {label}", fn(), plain(), BF16)
        h = x @ w1b
        gemms = [lambda: x @ w1b, lambda: h @ w2b]
    else:
        # x, g, dx; dh and a; W1 and W2 in bf16; b1
        flops = 6.0 * M * H * I
        nbytes = 3 * M * H * 2 + 2 * M * I * 2 + 2 * H * I * 2 + I * 4
        bound, by = _bound_ms(flops, nbytes, BF16)
        fn = lambda: fused_ffn_bwd(x, g, w1, b1, w2, act=act)  # noqa: E731
        plain = lambda: fused_ffn_bwd_plain(x, g, w1, b1, w2, act=act)  # noqa: E731
        got, want = fn(), plain()
        err = max(_compare_rel(f"ffn dx bf16 {label}", got[0], want[0], BF16),
                  _compare_rel(f"ffn dh bf16 {label}", got[1], want[1], BF16),
                  _compare(f"ffn a bf16 {label}", got[2], want[2], BF16))
        dh = got[1]
        gemms = [lambda: x @ w1b, lambda: g @ w2b.T, lambda: dh @ w1b.T]
    t = dict(max_abs_err=err, ms=_time_ms(fn), plain_ms=_time_ms(plain, iters=3),
             bound_ms=bound, bound_by=by, library_ms=None,
             cublas_gemms_ms=sum(_time_ms(f) for f in gemms))
    log(f"# rate ffn_train_{'bwd' if backward else 'fwd'} {label}: "
        f"{flops / (t['ms'] * 1e-3) / 1e12!r} TFLOP/s at {flops:.4g} flops; "
        f"{t['ms'] / t['cublas_gemms_ms']!r} x the {len(gemms)} cuBLAS products")
    return t


def _train_step_seconds(cfg: STonKGsConfig, state, label: str) -> float:
    """The median seconds of 6 ``make_train_step`` steps at B=32 in bf16
    after 2 of warm-up, each synchronised by its loss."""
    tx = AdamW(total_steps=1000)
    step = pretraining.make_train_step(cfg, tx, compute_dtype=BF16)
    feats = _pretraining_features(cfg, TRAIN_BATCH, seed=11)
    batch = pretraining.to_device(feats, DEV)
    times = []
    for i in range(2 + 6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        if i >= 2:
            times.append(time.perf_counter() - t0)
        check(math.isfinite(loss), "non-finite loss in the timed steps")
    med = statistics.median(times)
    log(f"# train step{label} B={TRAIN_BATCH} bf16: seconds {times!r}; median "
        f"{med * 1e3!r} ms, {TRAIN_BATCH / med!r} examples/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    return med


def phase_train_timing(cfg: STonKGsConfig, state) -> dict:
    """Step time at B=32 (sync through the loss), then each training kernel
    at the step's shapes; returns, per kernel, the trunk shape's numbers."""
    med = _train_step_seconds(cfg, state, "")
    gen = torch.Generator(device=DEV).manual_seed(4)
    tl, sl, B = cfg.text_len, cfg.seq_len, TRAIN_BATCH
    cases = {
        "flash_attention_train_fwd": [
            (f"trunk B={B} S={sl} mask", _time_train_attention, (B, sl, True, False)),
            (f"backbone B={B} S={tl} no-bias", _time_train_attention, (B, tl, False, False))],
        "flash_attention_train_bwd": [
            (f"trunk B={B} S={sl} mask", _time_train_attention, (B, sl, True, True))],
        "ffn_train_fwd": [(f"trunk M={B * sl}", _time_train_ffn, (B * sl, False)),
                          (f"backbone M={B * tl}", _time_train_ffn, (B * tl, False))],
        "ffn_train_bwd": [(f"trunk M={B * sl}", _time_train_ffn, (B * sl, True))],
    }
    result = {}
    for name, shapes in cases.items():
        for i, (label, fn, args) in enumerate(shapes):
            t = fn(label, *args[:-1], gen, args[-1])
            log(f"# time {name} {label} bf16: {json.dumps(t)}")
            if i == 0:
                result[name] = t
            else:
                result[name]["max_abs_err"] = max(result[name]["max_abs_err"],
                                                  t["max_abs_err"])
                result[name + ":backbone"] = t
    layers = cfg.bert.num_hidden_layers
    kern = (layers * (result["flash_attention_train_fwd"]["ms"]
                      + result["flash_attention_train_fwd:backbone"]["ms"]
                      + result["flash_attention_train_bwd"]["ms"]
                      + result["ffn_train_fwd"]["ms"] + result["ffn_train_fwd:backbone"]["ms"]
                      + result["ffn_train_bwd"]["ms"]))
    log(f"# kernel time per training step ({layers} backbone + {layers} trunk layers, "
        f"from the per-call times): {kern!r} ms of {med * 1e3!r} ms")
    return result


# ---------------------------------------------------------------------------
# ProtSTonKGs: serving and pre-training
# ---------------------------------------------------------------------------

PROT_BATCH = 8
PROT_ROWS = 32
PROT_TRAIN_BATCH = 2
PROT_TRAIN_STEPS = 4
PROT_SERVING_KERNELS = {"bigbird_mid_fwd": bigbird_mid_fwd, **SERVING_KERNELS}
PROT_TRAINING_KERNELS = {"bigbird_mid_fwd": bigbird_mid_fwd,
                         "bigbird_mid_bwd": bigbird_mid_bwd, **TRAINING_KERNELS}
# trainable leaves outside the ProtSTonKGs loss: the trunk reads backbone
# embeddings, not its word embeddings; there is no NSP head on the pooler;
# the decoder biases are never applied
PROT_UNUSED_LEAVES = ("trunk/embeddings/word_embeddings", "trunk/pooler/kernel",
                      "trunk/pooler/bias", "cls/predictions/text_bias",
                      "cls/predictions/entity_bias", "cls/predictions/prot_bias")


def _prot_cfg(kg_vocab: int = 20_000, layers: Optional[int] = None,
              hidden_dropout: Optional[float] = None) -> ProtSTonKGsConfig:
    """The published widths (BigBird trunk 12 x 768, BioBERT 12 x 768,
    ProtBERT 30 x 1024, 4096 = 768 | 256 | 3072), KG vocabulary 20,000 as
    ``benchmarks/bench_protstonkgs.py:31``; ``layers`` cuts every stack's
    depth, ``hidden_dropout`` sets every hidden dropout."""
    trunk, lm, prot = BigBirdConfig(), BertConfig(), ProtSTonKGsConfig().prot
    cut = {} if layers is None else {"num_hidden_layers": layers}
    if hidden_dropout is not None:
        cut["hidden_dropout_prob"] = hidden_dropout
    return ProtSTonKGsConfig(trunk=dataclasses.replace(trunk, **cut),
                             lm=dataclasses.replace(lm, **cut),
                             prot=dataclasses.replace(prot, **cut), kg_vocab_size=kg_vocab)


def _prot_params(cfg: ProtSTonKGsConfig, seed: int, dtype=F32):
    """Seeded random parameters (fp32 on the CPU) with the KG table built
    on the card in ``dtype``."""
    gen = torch.Generator().manual_seed(seed)
    params = protstonkgs.init_protstonkgs_params(gen, cfg)
    vectors = torch.randn(cfg.kg_vocab_size, cfg.trunk.hidden_size, generator=gen).numpy()
    lm = params_to(params["lm_backbone"], DEV, dtype)
    params["kg_backbone"] = protstonkgs.build_kg_table(lm, cfg, vectors,
                                                       compute_dtype=dtype).cpu()
    check(bool(torch.isfinite(params["kg_backbone"]).all()), "KG table not finite")
    return params


def _prot_features(cfg: ProtSTonKGsConfig, n: int, seed: int = 0, labels: bool = False):
    """Rows of uniform random ids with a full mask; with ``labels``, k =
    max(int(0.15 * len), 1) masked positions per segment, as
    ``benchmarks/bench_protstonkgs.py:115-134`` builds them."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([rng.integers(0, cfg.lm.vocab_size, (n, cfg.text_len)),
                          rng.integers(0, cfg.kg_table_size, (n, cfg.entity_len)),
                          rng.integers(0, cfg.prot_vocab_size, (n, cfg.prot_len))], 1)
    out = {"input_ids": ids.astype(np.int64),
           "attention_mask": np.ones((n, cfg.seq_len), np.int64)}
    if labels:
        for name, length, vocab in (("masked_lm_labels", cfg.text_len, cfg.lm_vocab_size),
                                    ("ent_masked_lm_labels", cfg.entity_len,
                                     cfg.kg_vocab_size),
                                    ("prot_masked_lm_labels", cfg.prot_len,
                                     cfg.prot_vocab_size)):
            k = max(int(length * 0.15), 1)
            lab = np.full((n, length), -100, np.int64)
            for i in range(n):
                lab[i, rng.choice(length, k, replace=False)] = rng.integers(0, vocab, k)
            out[name] = lab
    return out


def _train_plan(cfg: ProtSTonKGsConfig) -> np.ndarray:
    t = cfg.trunk
    return build_rand_attn(cfg.seq_len, t.block_size, t.num_random_blocks,
                           t.num_attention_heads, t.num_hidden_layers,
                           t.max_position_embeddings, training=True)


def _prot_embed_counted(label: str, engine, feats):
    """``engine.embed(feats)`` with the counts set to 0 just before it and
    read just after; checks the launches a batch (the trunk's layers but
    the [CLS]-only last one go through the sparse forward), the shape and
    finite output.  Returns the output and the counts."""
    cfg = engine.cfg
    n = len(feats["input_ids"])
    _reset_counts(PROT_SERVING_KERNELS)
    out = engine.embed(feats)
    counts = _counts(PROT_SERVING_KERNELS)
    n_batches = math.ceil(n / engine.batch_size)
    t, lm, prot = cfg.trunk, cfg.lm, cfg.prot
    per_batch = {"bigbird_mid_fwd": t.num_hidden_layers - 1,
                 "ffn_ln_block": lm.num_hidden_layers + prot.num_hidden_layers
                 + t.num_hidden_layers - 1,
                 "flash_attention_infer": lm.num_hidden_layers + prot.num_hidden_layers}
    log(f"# launches {label} (block {t.block_size}, {n_batches} batches of "
        f"{engine.batch_size}): {counts}")
    check(out.shape == (n, t.hidden_size), f"{label} shape {out.shape}")
    check(bool(np.isfinite(out).all()), f"{label} output not finite")
    for name, c in per_batch.items():
        check(counts[name] == c * n_batches,
              f"{label} {name}: {counts[name]} launches, expected {c} x {n_batches}")
    return out, counts


def _with_block(cfg: ProtSTonKGsConfig, block_size: int) -> ProtSTonKGsConfig:
    """``cfg`` with the BigBird trunk at ``block_size`` (its parameters do
    not depend on it)."""
    return cfg.replace(trunk=dataclasses.replace(cfg.trunk, block_size=block_size))


def phase_prot_serving(cfg: ProtSTonKGsConfig):
    """``ProtSTonKGsEngine.embed`` at full width (B=8, 32 rows): the main
    serving path, counts from 0 just before it; then card fp32 vs CPU fp32
    and card bf16 vs CPU fp32 on 2 rows at 2 layers per stack.  Returns
    the engine, the rows, the launch counts and the fp32 parameters."""
    t0 = time.perf_counter()
    params = _prot_params(cfg, seed=10, dtype=BF16)
    engine = ProtSTonKGsEngine(cfg=cfg, params=params_to(params, DEV, BF16),
                               batch_size=PROT_BATCH, device=DEV)
    feats = _prot_features(cfg, PROT_ROWS)
    log(f"# ProtSTonKGs serving setup (init + KG table): {time.perf_counter() - t0:.1f} s")
    out, counts = _prot_embed_counted("ProtSTonKGs embed", engine, feats)

    # numerics at 2 layers per stack, full widths and layout
    small = _prot_cfg(cfg.kg_vocab_size, layers=2)
    p32 = _prot_params(small, seed=11)
    few = _prot_features(small, 2, seed=1)
    card32 = ProtSTonKGsEngine(cfg=small, params=p32, compute_dtype="float32",
                               batch_size=2, device=DEV).embed(few)
    card16 = ProtSTonKGsEngine(cfg=small, params=params_to(p32, DEV, BF16),
                               batch_size=2, device=DEV).embed(few)
    cpu32 = ProtSTonKGsEngine(cfg=small, params=p32, compute_dtype="float32",
                              batch_size=2, device="cpu").embed(few)
    err32 = float(np.abs(card32 - cpu32).max())
    cos = _cosine(card16, cpu32)
    log(f"# ProtSTonKGs card fp32 vs CPU fp32 (2 rows, 2 layers a stack): max_abs_err "
        f"{err32!r} (limit 1e-3)")
    log(f"# ProtSTonKGs card bf16 vs CPU fp32 (2 rows, 2 layers a stack): cosine "
        f"{cos.tolist()!r} (limit 0.99)")
    check(err32 <= 1e-3, "ProtSTonKGs card fp32 disagrees with the CPU")
    check(bool((cos >= 0.99).all()), "ProtSTonKGs card bf16 too far from the CPU fp32")
    return engine, feats, counts, params


def phase_prot_training(cfg: ProtSTonKGsConfig, params_cpu: dict,
                        steps: int = PROT_TRAIN_STEPS):
    """``pretrain(..., loss_fn=protstonkgs.pretraining_loss)`` at full width
    (B=2, fp32 parameters, bf16 compute, the training plan of the trunk's
    block size) for ``steps`` steps: the main training path, counts from 0
    just before it.  Returns its launch counts, its state and the loss
    function."""
    t0 = time.perf_counter()
    bs = cfg.trunk.block_size
    params = params_to(params_cpu, DEV)
    frozen_before = tree_map(lambda t: t.clone(), split_frozen(params)[1])
    feats = _prot_features(cfg, PROT_TRAIN_BATCH * steps, seed=2, labels=True)
    loss_fn = functools.partial(protstonkgs.pretraining_loss, rand_attn=_train_plan(cfg))
    run_cfg = pretraining.PretrainingConfig(
        max_steps=steps, micro_batch_size=PROT_TRAIN_BATCH, log_steps=1,
        compute_dtype="bfloat16")
    logged = []
    log(f"# ProtSTonKGs training setup (block {bs}): {time.perf_counter() - t0:.1f} s")
    _reset_counts(PROT_TRAINING_KERNELS)
    state = pretraining.pretrain(cfg, params, feats, run_cfg, loss_fn=loss_fn,
                                 log_fn=lambda step, m: logged.append((step, m)))
    torch.cuda.synchronize()
    counts = _counts(PROT_TRAINING_KERNELS)
    t, lm, prot = cfg.trunk, cfg.lm, cfg.prot
    log(f"# launches ProtSTonKGs pretrain (block {bs}, {steps} steps, B={PROT_TRAIN_BATCH}): "
        f"{counts}")
    expected = {"bigbird_mid_fwd": t.num_hidden_layers, "bigbird_mid_bwd": t.num_hidden_layers,
                "ffn_train_fwd": lm.num_hidden_layers + prot.num_hidden_layers
                + t.num_hidden_layers,
                "ffn_train_bwd": t.num_hidden_layers,
                "flash_attention_train_fwd": lm.num_hidden_layers + prot.num_hidden_layers}
    for name, per_step in expected.items():
        check(counts[name] == per_step * steps,
              f"{name}: {counts[name]} launches, expected {per_step} x {steps}")
    for step, m in logged:
        log(f"# ProtSTonKGs pretrain (block {bs}) step {step}: " + json.dumps(m))
    check([s for s, _ in logged] == list(range(1, steps + 1)),
          f"ProtSTonKGs pretrain logged steps {[s for s, _ in logged]}")
    check(all(math.isfinite(m["loss"]) for _, m in logged),
          "non-finite ProtSTonKGs pretraining loss")
    frozen_after = split_frozen(state.params)[1]
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(frozen_before),
                                                tree_leaves(frozen_after))),
          "a frozen ProtSTonKGs backbone changed")
    before, after = tree_flatten_with_path(split_frozen(params)[0]), tree_flatten_with_path(state.params)
    unchanged = [k for k in before if torch.equal(before[k], after[k])]
    log(f"# ProtSTonKGs trainable leaves unchanged after {steps} steps: {unchanged}")
    check(set(unchanged) <= set(PROT_UNUSED_LEAVES), "a trainable leaf did not change")
    check(not any(k.startswith("prot_projection") for k in unchanged),
          "prot_projection did not train")
    return counts, state, loss_fn


# rows and layers a stack of phase 13's card-against-CPU loss and
# gradients: its CPU half at S=4096 and full width took 123 s of the smoke
# at 2 rows and 2 layers (blocks 64 and 128), the most of any phase's part
PROT_NUMERICS_ROWS, PROT_NUMERICS_LAYERS = 1, 1


def phase_prot_train_numerics(cfg_full: ProtSTonKGsConfig, block_size: int = 64) -> None:
    """Loss and trunk gradients, card fp32 vs CPU fp32, at
    PROT_NUMERICS_ROWS rows and PROT_NUMERICS_LAYERS layers a stack of the
    full widths, the trunk at ``block_size`` (its training plan) and at
    ``cfg_full``'s head split, hidden dropout 0 and the backbones'
    attention dropout 0.1 (seeds from the same CPU generator)."""
    cfg = _with_block(_prot_cfg(cfg_full.kg_vocab_size, layers=PROT_NUMERICS_LAYERS,
                                hidden_dropout=0.0), block_size)
    cfg = cfg.replace(trunk=dataclasses.replace(
        cfg.trunk, num_attention_heads=cfg_full.trunk.num_attention_heads))
    params = _prot_params(cfg, seed=12)
    feats = _prot_features(cfg, PROT_NUMERICS_ROWS, seed=3, labels=True)
    plan = _train_plan(cfg)

    def loss_and_grads(device):
        p = params_to(params, device)
        leaves = tree_leaves(p["trunk"]) + tree_leaves(p["prot_projection"])
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = protstonkgs.pretraining_loss(
            p, cfg, pretraining.to_device(feats, device), deterministic=False,
            rng=pretraining.step_rng(0, 0, device), compute_dtype=F32, rand_attn=plan)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return float(loss.detach()), [g.detach().cpu() for g in grads if g is not None]

    launches = bigbird_mid_bwd.launches
    loss_card, g_card = loss_and_grads(DEV)
    check(bigbird_mid_bwd.launches > launches, "the card run launched no sparse backward")
    loss_cpu, g_cpu = loss_and_grads("cpu")
    err = max(float((a - b).abs().max()) for a, b in zip(g_card, g_cpu))
    scale = max(float(b.abs().max()) for b in g_cpu)
    log(f"# ProtSTonKGs train card fp32 vs CPU fp32 (block {block_size}, rows "
        f"{PROT_NUMERICS_ROWS}, layers a stack {PROT_NUMERICS_LAYERS}, attention dropout "
        f"{ATTN_RATE}): loss "
        f"{loss_card!r} vs {loss_cpu!r}; trunk and "
        f"projection grads max_abs_err {err!r} of max |grad| {scale!r} (limits: loss 1e-4 "
        f"relative, grads 1e-3 of max |grad|)")
    check(abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu),
          "ProtSTonKGs card loss disagrees with the CPU")
    check(err <= 1e-3 * scale, "ProtSTonKGs card gradients disagree with the CPU")


def _time_sparse(label: str, B: int, gen, backward: bool, plan: str, bs: int = 64,
                 S: int = 4096, H: int = 12, D: int = 64, r: int = 3) -> dict:
    """A BigBird kernel vs plain at a path's shape (by default the trunk's:
    S=4096, H=12, D=64, r=3, block ``bs``), then both timed, beside the
    bound and the design's floor (the forward: two exps a score on the SFU
    or its three products; the backward: its seven products, dS as two
    bf16 terms, or its one exp a score; a partial tile's products counted
    padded to 64 rows and keys) and the library call: SDPA over operands
    gathered beforehand (``benchmarks/bigbird_sdpa.py``), its backward
    alone over a saved forward."""
    nb = S // bs
    q, k, v, mask, rand, do = _sparse_inputs(B, nb, BF16, gen, plan, False, H, bs, D, r)
    n_mid, W = nb - 2, (5 + r) * bs
    padded = (-bs) % 64 + bs                   # rows of a block's tiles
    padded_scores = B * H * n_mid * padded * (5 + r) * padded
    tensor = B * S * H * D * 2                 # one (B, S, H, D) bf16 tensor
    mid = B * n_mid * bs * H * D * 2           # its middle rows
    lse_b, mask_b = B * H * n_mid * bs * 4, B * S * 4
    scores = B * H * n_mid * bs * W
    products = 2.0 * scores * D                # one (bs x W x D) product per block
    out, lse = bigbird_mid_fwd(q, k, v, mask, rand, bs)
    qg, kg, vg, bias = gathered_operands(q, k, v, mask, rand, bs)
    if not backward:
        # q's middle rows, k, v and the mask read; out and lse written
        bound, by = _bound_ms(2 * products, 2 * mid + 2 * tensor + lse_b + mask_b, BF16)
        floor = max(2 * padded_scores / EX2_PER_S,
                    3 * 2.0 * padded_scores * D / PEAK_FLOPS[BF16]) * 1e3
        fn = lambda: bigbird_mid_fwd(q, k, v, mask, rand, bs)  # noqa: E731
        plain = lambda: bigbird_mid_fwd_plain(q, k, v, mask, rand, bs)  # noqa: E731
        want = plain()[0]
        err = _compare_attn(f"sparse fwd bf16 {label}", fn()[0], want, BF16)
        sdpa_err = float((to_ctx(sdpa_mid(qg, kg, vg, bias), B, H).float() - want.float())
                         .abs().max())
        log(f"# sparse fwd bf16 {label}: SDPA over the gathered operands against the plain "
            f"version: max_abs_err {sdpa_err!r} (not gated: SDPA rounds elsewhere)")
        lib = _time_ms(lambda: sdpa_mid(qg, kg, vg, bias))
    else:
        # q, o, dO middle rows, k, v, lse, mask read; dq (middle), dk, dv written
        bound, by = _bound_ms(5 * products, 4 * mid + 4 * tensor + lse_b + mask_b, BF16)
        floor = max(padded_scores / EX2_PER_S,
                    7 * 2.0 * padded_scores * D / PEAK_FLOPS[BF16]) * 1e3
        fn = lambda: bigbird_mid_bwd(q, k, v, mask, rand, bs, out, lse, do)  # noqa: E731
        plain = lambda: bigbird_mid_bwd_plain(q, k, v, mask, rand, bs, out, lse, do)  # noqa: E731
        err = max(_compare_grad(f"sparse {n} bf16 {label}", g, w, BF16)
                  for n, g, w in zip(("dq", "dk", "dv"), fn(), plain()))
        lib = _time_sdpa_backward(f"BigBird {label} (gathered)", qg, kg, vg, bias,
                                  torch.randn(qg.shape, generator=gen).to(DEV, BF16))
    t = dict(max_abs_err=err, ms=_time_ms(fn), plain_ms=_time_ms(plain, iters=3),
             bound_ms=bound, bound_by=by, library_ms=lib, floor_ms=floor)
    log(f"# rate bigbird_mid_{'bwd' if backward else 'fwd'} {label}: {t['ms'] / floor!r} x "
        f"the floor, {t['ms'] / lib!r} x SDPA over the gathered operands")
    return t


def _prot_embed_rate(engine, feats) -> float:
    """Median sequences/s of three ``embed`` calls over ``feats``."""
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.embed(feats)
        times.append(time.perf_counter() - t0)
    check(bool(np.isfinite(out).all()), "ProtSTonKGs embed not finite")
    log(f"# ProtSTonKGs embed (block {engine.cfg.trunk.block_size}): {len(out)} rows, "
        f"B={engine.batch_size}, seconds {times!r}; best {len(out) / min(times)!r} "
        f"sequences/s, median {len(out) / statistics.median(times)!r} sequences/s")
    return len(out) / statistics.median(times)


def _prot_step_ms(cfg: ProtSTonKGsConfig, state, loss_fn) -> float:
    """The training step's median ms (B=2, bf16, 6 steps after 2 of
    warm-up, each synchronised by its loss)."""
    tx = AdamW(total_steps=1000)
    step = pretraining.make_train_step(cfg, tx, loss_fn=loss_fn, compute_dtype=BF16)
    batch = pretraining.to_device(_prot_features(cfg, PROT_TRAIN_BATCH, seed=4, labels=True),
                                  DEV)
    times = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(2 + 6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        if i >= 2:
            times.append(time.perf_counter() - t0)
        check(math.isfinite(loss), "non-finite ProtSTonKGs loss in the timed steps")
    med = statistics.median(times)
    log(f"# ProtSTonKGs train step (block {cfg.trunk.block_size}) B={PROT_TRAIN_BATCH} bf16: "
        f"seconds {times!r}; median {med * 1e3!r} ms, {PROT_TRAIN_BATCH / med!r} sequences/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    return med * 1e3


def phase_prot_timing(cfg: ProtSTonKGsConfig, engine, feats, state, loss_fn) -> dict:
    """Embed sequences/s (B=8), the training step (B=2, median of 6 after
    2 of warm-up), then each new or widened kernel at the ProtSTonKGs
    path's shapes.  Returns per kernel the path shape's numbers, and under
    "path" the embed sequences/s and the step's median ms."""
    path = {"sequences_per_s": _prot_embed_rate(engine, feats),
            "step_ms": _prot_step_ms(cfg, state, loss_fn)}
    del state
    gen = torch.Generator().manual_seed(7)
    B, Bt = PROT_BATCH, PROT_TRAIN_BATCH
    cases = [
        ("bigbird_mid_fwd", f"serving B={B} S=4096 eval plan",
         lambda lb: _time_sparse(lb, B, gen, False, "eval")),
        ("bigbird_mid_fwd:train", f"training B={Bt} S=4096 train plan",
         lambda lb: _time_sparse(lb, Bt, gen, False, "train")),
        ("bigbird_mid_bwd", f"training B={Bt} S=4096 train plan",
         lambda lb: _time_sparse(lb, Bt, gen, True, "train")),
        ("ffn_ln_block:prot", f"ProtBERT M={B * cfg.prot_len} H=1024",
         lambda lb: _time_ffn(lb, B * cfg.prot_len, gen, 1024, 4096)),
        ("ffn_ln_block:bigbird", f"trunk M={B * cfg.seq_len} gelu_new",
         lambda lb: _time_ffn(lb, B * cfg.seq_len, gen, act="gelu_new")),
        ("flash_attention_infer:prot", f"ProtBERT B={B} S={cfg.prot_len} H=16 no-bias",
         lambda lb: _time_attention(lb, B, cfg.prot_len, False, gen, H=16)),
        ("ffn_train_fwd:prot", f"ProtBERT M={Bt * cfg.prot_len} H=1024",
         lambda lb: _time_train_ffn(lb, Bt * cfg.prot_len, gen, False, 1024, 4096)),
        ("ffn_train_fwd:bigbird", f"trunk M={Bt * cfg.seq_len} gelu_new",
         lambda lb: _time_train_ffn(lb, Bt * cfg.seq_len, gen, False, act="gelu_new")),
        ("ffn_train_bwd:bigbird", f"trunk M={Bt * cfg.seq_len} gelu_new",
         lambda lb: _time_train_ffn(lb, Bt * cfg.seq_len, gen, True, act="gelu_new")),
        ("ffn_train_fwd:biobert", f"BioBERT M={Bt * cfg.text_len}",
         lambda lb: _time_train_ffn(lb, Bt * cfg.text_len, gen, False)),
        ("flash_attention_train_fwd:prot",
         f"ProtBERT B={Bt} S={cfg.prot_len} H=16 no-bias, rate 0.1",
         lambda lb: _time_train_attention(lb, Bt, cfg.prot_len, False, gen, False, H=16)),
    ]
    result = {}
    for key, label, fn in cases:
        t = fn(label)
        log(f"# time {key.split(':')[0]} {label} bf16: {json.dumps(t)}")
        result[key] = t
    result["bigbird_mid_fwd"]["max_abs_err"] = max(
        result["bigbird_mid_fwd"]["max_abs_err"], result["bigbird_mid_fwd:train"]["max_abs_err"])
    result["path"] = path
    return result


# ---------------------------------------------------------------------------
# ProtSTonKGs at block 128: serving, pre-training and loading, full width
# ---------------------------------------------------------------------------

PROT128_STEPS = 2     # pretrain steps at block 128
PROT128_ENTITIES = 5_000   # the loaded model's KG vocabulary (phase 19's TSV size)


def _prot_cut_kg(params: dict, cfg: ProtSTonKGsConfig, n: int):
    """``params`` and ``cfg`` with the KG vocabulary cut to its first ``n``
    entities: the entity decoder and its bias sliced (the KG table is
    built from the TSVs on loading)."""
    pred = dict(params["cls"]["predictions"])
    pred["entity_decoder"] = {"kernel": pred["entity_decoder"]["kernel"][:, :n].contiguous()}
    pred["entity_bias"] = pred["entity_bias"][:n].contiguous()
    return ({**params, "cls": {**params["cls"], "predictions": pred}},
            cfg.replace(kg_vocab_size=n))


def _prot128_roundtrip(cfg: ProtSTonKGsConfig, params: dict, card: str) -> None:
    """``save_protstonkgs_pretrained`` -> ``ProtSTonKGsEngine.from_pretrained``
    of the block-128 model (KG vocabulary cut to ``PROT128_ENTITIES``, with
    node2vec TSVs of that many 768-wide vectors), in a temporary directory
    removed at the end: the config.json holds block size 128, the loaded
    trunk runs at 128 (its launch counts), and its embeddings equal an
    engine's built from the parameters in memory, bit for bit."""
    p, cut = _prot_cut_kg(params, cfg, PROT128_ENTITIES)
    with tempfile.TemporaryDirectory(prefix="stonkgs_prot128_") as tmp:
        t0 = time.perf_counter()
        ckpt = save_protstonkgs_pretrained(p, cut, os.path.join(tmp, "ckpt"))
        art = make_random_artifacts(PROT128_ENTITIES, dim=cut.trunk.hidden_size,
                                    rw_len=README_RW_LEN, seed=16)
        emb, walks = os.path.join(tmp, "emb.tsv"), os.path.join(tmp, "walks.tsv")
        save_kg_artifacts(art, emb, walks)
        with open(os.path.join(ckpt, "config.json")) as f:
            written = json.load(f)
        log(f"# ProtSTonKGs block 128 files written in {time.perf_counter() - t0:.1f} s "
            f"(checkpoint {_dir_gb(ckpt)!r} GB, config.json block_size "
            f"{written['block_size']})")
        check(written["block_size"] == 128, "config.json does not hold block size 128")
        t0 = time.perf_counter()
        loaded = ProtSTonKGsEngine.from_pretrained(ckpt, emb, walks, batch_size=PROT_BATCH,
                                                   device=DEV)
        log(f"# ProtSTonKGs block 128 from_pretrained: {time.perf_counter() - t0!r} s ({card})")
        check(loaded.cfg.trunk == cut.trunk, f"loaded trunk {loaded.cfg.trunk} differs from "
              f"{cut.trunk}")
        feats = _prot_features(cut, PROT_ROWS, seed=5)
        got, _ = _prot_embed_counted("ProtSTonKGs block 128 loaded embed", loaded, feats)
        mem = params_to(p, DEV)
        mem["kg_backbone"] = protstonkgs.build_kg_table(mem["lm_backbone"], cut, art.vectors)
        want = dataclasses.replace(loaded, params=mem).embed(feats)
        err = float(np.abs(got - want).max())
        log(f"# ProtSTonKGs block 128 loaded vs in-memory engine ({PROT_ROWS} rows, bf16): "
            f"max_abs_err {err!r}")
        check(err == 0.0, "the loaded block-128 engine's embeddings differ from the in-memory "
              "engine's")
        del loaded, mem
    torch.cuda.empty_cache()


def phase_prot_block128(cfg64: ProtSTonKGsConfig, params: dict, feats: dict, prot_times: dict,
                        card: str) -> tuple:
    """ProtSTonKGs with the trunk at ``block_size=128`` (phase 11's
    parameters and rows): (a) ``ProtSTonKGsEngine.embed`` at B=8 on 32 rows,
    counts from 0 just before it, and 2 rows of it against the card's fp32
    engine (cosine 0.99); (b) ``pretrain`` at B=2 for 2 steps (launch
    counts, finite losses, frozen backbones unchanged); (c) a save ->
    ``from_pretrained`` round trip; (d) sequences/s, the step's median ms
    and the kernel pair's times at block 128 beside phase 14's at block 64.
    Returns the launch counts of (a) and (b) and the kernel pair's times."""
    cfg = _with_block(cfg64, 128)
    engine = ProtSTonKGsEngine(cfg=cfg, params=params_to(params, DEV, BF16),
                               batch_size=PROT_BATCH, device=DEV)
    out, counts = _prot_embed_counted("ProtSTonKGs embed", engine, feats)
    few = {k: v[:2] for k, v in feats.items()}
    card32 = ProtSTonKGsEngine(cfg=cfg, params=params, compute_dtype="float32", batch_size=2,
                               device=DEV).embed(few)
    cos = _cosine(out[:2], card32)
    log(f"# ProtSTonKGs block 128 card bf16 vs card fp32 (2 rows, full depth): cosine "
        f"{cos.tolist()!r} (limit 0.99)")
    check(bool((cos >= 0.99).all()), "ProtSTonKGs block 128 bf16 too far from the card fp32")
    del card32
    train_counts, state, loss_fn = phase_prot_training(cfg, params, steps=PROT128_STEPS)
    for name, c in train_counts.items():
        counts[name] = counts.get(name, 0) + c
    path = {"sequences_per_s": _prot_embed_rate(engine, feats),
            "step_ms": _prot_step_ms(cfg, state, loss_fn)}
    del state, loss_fn, engine
    torch.cuda.empty_cache()
    _prot128_roundtrip(cfg, params, card)
    b64 = prot_times["path"]
    log(f"# ProtSTonKGs block 128 vs block 64 ({card}): embed {path['sequences_per_s']!r} vs "
        f"{b64['sequences_per_s']!r} sequences/s; step {path['step_ms']!r} vs "
        f"{b64['step_ms']!r} ms")
    gen = torch.Generator().manual_seed(8)
    B, Bt = PROT_BATCH, PROT_TRAIN_BATCH
    times = {}
    for key, label, Bk, backward, plan in (
            ("bigbird_mid_fwd", f"serving B={B} S=4096 eval plan", B, False, "eval"),
            ("bigbird_mid_fwd:train", f"training B={Bt} S=4096 train plan", Bt, False, "train"),
            ("bigbird_mid_bwd", f"training B={Bt} S=4096 train plan", Bt, True, "train")):
        t = _time_sparse(f"bs=128 {label}", Bk, gen, backward, plan, bs=128)
        log(f"# time {key.split(':')[0]} bs=128 {label} bf16: {json.dumps(t)}")
        t64 = prot_times[key]
        log(f"# bigbird bs=128 / bs=64 {key} {label} ({card}): {t['ms']!r} / {t64['ms']!r} ms "
            f"= {t['ms'] / t64['ms']!r}")
        times[key] = t
    return counts, times


# ---------------------------------------------------------------------------
# int8 serving: the fused int8 dense and the int8 GEMM probe
# ---------------------------------------------------------------------------

INT8_SERVING_KERNELS = {"dense_int8": dense_int8_fused, **SERVING_KERNELS}
PROT_INT8_SERVING_KERNELS = {"dense_int8": dense_int8_fused, **PROT_SERVING_KERNELS}
# (M, K, N) of the int8 paths' denses: the STonKGs trunk (B=128 x 512 rows)
# and backbone (x 256; the ProtSTonKGs BigBird trunk, B=8 x 4096, has the
# same M), ProtBERT (B=8 x 3072) and its projection to 768, and BioBERT in
# ProtSTonKGs (3 text chunks a row: 24 x 256)
INT8_SHAPES = {
    "trunk Q/K/V/O": (65536, 768, 768), "trunk FFN in": (65536, 768, 3072),
    "trunk FFN out": (65536, 3072, 768), "backbone Q/K/V/O": (32768, 768, 768),
    "backbone FFN in": (32768, 768, 3072), "backbone FFN out": (32768, 3072, 768),
    "ProtBERT Q/K/V/O": (24576, 1024, 1024), "ProtBERT FFN in": (24576, 1024, 4096),
    "ProtBERT FFN out": (24576, 4096, 1024), "protein projection": (24576, 1024, 768),
    "BioBERT Q/K/V/O": (6144, 768, 768), "BioBERT FFN in": (6144, 768, 3072),
    "BioBERT FFN out": (6144, 3072, 768),
}
# the [CLS] layers' denses (STonKGs 128 rows, ProtSTonKGs 8), the edges and
# the decoders (N = 28,996, 100,000)
INT8_EDGES = [(128, 768, 768), (128, 768, 3072), (128, 3072, 768), (8, 768, 768),
              (8, 768, 3072), (8, 3072, 768), (0, 768, 768), (1, 768, 768), (300, 768, 3072),
              (64, 768, 100), (128, 768, 28996), (8, 768, 100000),
              # K % 32 == 16: TMA zero-fills the last k32 step
              (300, 48, 100), (1, 784, 100), (128, 48, 28996), (300, 784, 28996)]
# card vs CPU layer by layer (both fp32, int8, each layer fed the CPU's
# input): the share of activation codes that may differ.  A code flips
# where the two fp32 inputs of a dense straddle a rounding boundary, a
# chance of order 1e-5 a code; the bf16 control flips of order 1e-1
INT8_FLIP_LIMIT = 1e-3
GEMM_SIZE = 4096


def _int8_dense_inputs(M, K, N, dtype, gen, zero_row=False):
    """x (M, K) in dtype on the card (row 1 zero with ``zero_row``), an
    int8 (K, N) weight, column-major as the engines hold it, with its fp32
    scales, and an fp32 bias."""
    x = torch.randn(M, K, device=DEV, generator=gen).to(dtype)
    if zero_row and M > 1:
        x[1] = 0
    q = quantize_kernel(0.02 * torch.randn(K, N, device=DEV, generator=gen))
    return (x, k_major(q["kernel_q"]), q["scale"],
            0.02 * torch.randn(N, device=DEV, generator=gen))


def _check_codes(name, x) -> None:
    """The row-quantize pass's codes and scales equal to ``quantize_rows``
    (the plain version, on the card) bit for bit."""
    got_q, got_s = dense_int8_quantize(x)
    want_q, want_s = quantize_rows(x.reshape(-1, x.shape[-1]))
    torch.cuda.synchronize()
    flips = int((got_q != want_q).sum())
    same_s = torch.equal(got_s, want_s.reshape(-1))
    log(f"# check {name} codes and scales: {flips} of {want_q.numel()} codes differ, scales "
        f"{'equal' if same_s else 'DIFFER'} {'ok' if flips == 0 and same_s else 'FAIL'}")
    check(flips == 0 and same_s, f"{name}: the row-quantize pass differs from quantize_rows")


def _int8_limits_reject(gen) -> None:
    """The phase's limits against two known faults, applied to the plain
    version: codes made with a reciprocal (x * (1 / s) instead of x / s)
    differ from the pass's exact codes and move the fp32 output past
    INT8_F32_TOL; an epilogue without s_w fails the bf16 tolerance."""
    M, K, N = INT8_SHAPES["trunk FFN out"]
    x, w, s, b = _int8_dense_inputs(M, K, N, F32, gen)
    q, sx = quantize_rows(x)
    recip = torch.clamp(torch.round(x * torch.reciprocal(sx)), -127, 127).to(I8)
    flips = int((recip != q).sum())
    log(f"# check dense_int8 fault: codes with a reciprocal at M={M} {K}->{N} fp32: {flips} of "
        f"{q.numel()} codes differ from the exact ones {'rejected: ok' if flips else 'FAIL'}")
    check(flips > 0, "the exact code check does not catch codes made with a reciprocal")
    want = _dequant_plain(q, sx, w, s, b, F32)
    err = float((_dequant_plain(recip, sx, w, s, b, F32) - want).abs().max())
    limit = INT8_F32_TOL * float(want.abs().max())
    log(f"# check dense_int8 fault: its fp32 output: max_abs_err {err!r} limit {limit!r} "
        f"{'passes: FAIL' if err <= limit else 'rejected: ok'}")
    check(err > limit, "the fp32 limit does not catch codes made with a reciprocal")
    del x, q, recip, want
    x, w, s, b = _int8_dense_inputs(300, 768, 768, BF16, gen)
    want = dense_int8_fused_plain(x, w, s, b)
    q, sx = quantize_rows(x)
    wrong = _dequant_plain(q, sx, w, torch.ones_like(s), b, BF16)
    ok = bool(torch.allclose(wrong.float(), want.float(), **TOL[BF16]))
    log(f"# check dense_int8 fault: epilogue without s_w, bf16 M=300: max_abs_err "
        f"{float((wrong.float() - want.float()).abs().max())!r} "
        f"{'passes: FAIL' if ok else 'rejected: ok'}")
    check(not ok, "the bf16 tolerance does not catch an epilogue without s_w")


def _compare_int8(name, got, want, dtype) -> float:
    """bf16: within TOL[BF16]; fp32: within INT8_F32_TOL of max |want|."""
    if dtype == BF16:
        return _compare(name, got, want, dtype)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    limit = INT8_F32_TOL * (float(want.abs().max()) if want.numel() else 0.0)
    log(f"# check {name}: max_abs_err {err!r} limit {limit!r} {'ok' if err <= limit else 'FAIL'}")
    check(err <= limit, f"{name}: kernel disagrees with its plain version")
    return err


def phase_int8_kernels() -> dict:
    """The int8 dense vs its plain version on the card, bf16 and fp32, at
    the paths' shapes and the edges, its row-quantize pass's codes and
    scales bit for bit, and the limits against two known faults; the GEMM
    probe exactly equal to its plain version (int8), within tolerance
    (bf16).  Returns the worst bf16 error at the paths' shapes."""
    gen = torch.Generator(device=DEV).manual_seed(20)
    errs = {"dense_int8": 0.0}
    for dtype in (BF16, F32):
        tag = "bf16" if dtype == BF16 else "fp32"
        for M, K, N in [*INT8_SHAPES.values(), *INT8_EDGES]:
            x, w, s, b = _int8_dense_inputs(M, K, N, dtype, gen, zero_row=True)
            _check_codes(f"dense_int8 {tag} M={M} K={K}", x)
            e = _compare_int8(f"dense_int8 {tag} M={M} {K}->{N} zero row",
                              dense_int8_fused(x, w, s, b), dense_int8_fused_plain(x, w, s, b),
                              dtype)
            if dtype == BF16 and (M, K, N) in INT8_SHAPES.values():
                errs["dense_int8"] = max(errs["dense_int8"], e)
            del x, w, s, b
        x, w, s, _ = _int8_dense_inputs(300, 768, 768, dtype, gen)
        _compare_int8(f"dense_int8 {tag} M=300 no bias", dense_int8_fused(x, w, s),
                      dense_int8_fused_plain(x, w, s), dtype)
        # the [CLS] rows of the trunk's (B, S, H) activation: a strided view
        h = torch.randn(BATCH, 512, 768, device=DEV, generator=gen).to(dtype)[:, :1]
        _compare_int8(f"dense_int8 {tag} x[:, :1] of ({BATCH}, 512, 768)",
                      dense_int8_fused(h, w, s), dense_int8_fused_plain(h.contiguous(), w, s),
                      dtype)
        _check_codes(f"dense_int8 {tag} x[:, :1]", h)
        # a row-major weight: correct, through a K-major copy made for the call
        w_row = w.contiguous()
        _compare_int8(f"dense_int8 {tag} M=300 row-major kernel_q", dense_int8_fused(x, w_row, s),
                      dense_int8_fused_plain(x, w_row, s), dtype)
        del h, w_row
    _int8_limits_reject(gen)
    ops = bench_int8_gemm.operands(GEMM_SIZE, GEMM_SIZE, GEMM_SIZE)
    errs["int8_gemm"] = 0.0
    for a, b in ((ops["a8"][:512, :1024], ops["b8"][:1024, :512]), (ops["a8"], ops["b8"])):
        err = _gemm_int8_err(a, b)
        log(f"# check int8_gemm int8 {tuple(a.shape)} x {tuple(b.shape)}: max_abs_err {err!r} "
            f"(exactly equal)")
        check(err == 0, "int8_gemm: int8 result differs from its plain version")
        errs["int8_gemm"] = max(errs["int8_gemm"], err)
    errs["int8_gemm"] = max(errs["int8_gemm"], _compare_rel(
        f"int8_gemm bf16 {GEMM_SIZE}^3", int8_gemm(ops["abf"], ops["bbf"]),
        int8_gemm_plain(ops["abf"], ops["bbf"]), F32))
    return errs


def _gemm_int8_err(a, b) -> float:
    """max |kernel - plain| of the probe's int8 product (exact in fp64)."""
    got, want = int8_gemm(a, b), int8_gemm_plain(a, b)
    torch.cuda.synchronize()
    check(got.dtype == want.dtype == torch.int32 and got.shape == want.shape,
          f"int8_gemm: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    return float((got.double() - want.double()).abs().max())


def _time_embed_in_turns(label: str, engines: dict, feats: dict, unit: str) -> dict:
    """Each engine's embed 3 times, in turns; logs rows/s and returns the
    last outputs by name."""
    times = {name: [] for name in engines}
    outs = {}
    for _ in range(3):
        for name, eng in engines.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name] = eng.embed(feats)
            times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        n = len(outs[name])
        check(bool(np.isfinite(outs[name]).all()), f"{label} {name} embed not finite")
        log(f"# embed {label} {name}: {n} rows, B={engines[name].batch_size}, seconds {ts!r}; "
            f"best {n / min(ts)!r} {unit}, median {n / statistics.median(ts)!r} {unit}")
    return outs


# int8 at any K (phase 16 (c)): K no multiple of the kernel's step of 16
# (8, 72, 100: the 100-wide config's Q/K/V/O and FFN in), K = 400 (its FFN
# out) and the 2560-wide config's 2,560 and 10,240, each (M, K, N) a path's
# dense or an edge (M = 1, the decoder's N = 28,996)
INT8_ANY_K = ((300, 8, 768), (1, 72, 100), (300, 72, 768), (300, 100, 100), (1000, 100, 400),
              (1000, 400, 100), (128, 100, 28996), (300, 2560, 2560), (300, 2560, 10240),
              (300, 10240, 2560))
# the planted fault's shape: the product without its last partial K step
INT8_FAULT = (1000, 100, 400)
# (hidden, heads, intermediate) of the int8 engines at the CLI's 100-wide
# config (K = 100) and the 2560-wide one (K = 2,560 and 10,240), with
# WIDEST_ENTITIES KG entities
INT8_WIDE_CFGS = ((100, 2, 400), (2560, 40, 10240))
# the kernel line's K=100 shape: the 100-wide trunk's FFN in at B=128
INT8_K100 = ("100-wide trunk FFN in", BATCH * 512, 100, 400)


def _int8_limit_rejects(name, want, wrong, dtype) -> None:
    """Fail unless ``_compare_int8``'s limit (TOL in bf16, INT8_F32_TOL of
    max |want| in fp32) tells ``wrong`` from ``want``."""
    g, w = wrong.float(), want.float()
    err = float((g - w).abs().max())
    if dtype == BF16:
        passes = bool(torch.allclose(g, w, **TOL[BF16]))
    else:
        passes = err <= INT8_F32_TOL * float(w.abs().max())
    log(f"# check {name}: max_abs_err {err!r} max|plain| {float(w.abs().max())!r} "
        f"{'passes: FAIL' if passes else 'rejected: ok'}")
    check(not passes, f"{name}: the int8 limit does not catch this fault")


def _int8_any_k(gen) -> float:
    """(c) The int8 dense at every (M, K, N) of INT8_ANY_K against its
    plain version, bf16 and fp32: the row-quantize pass's codes and scales
    bit for bit, the dense from one call (a zero row included) and from
    its two launches apart, on the column-major weight that
    ``quantized_to`` lays out (rows of padded_k(K) codes) and on a
    row-major one (copied so for the call).  At INT8_FAULT the limits must
    reject the plain product without its last partial K step (codes
    96-99 of K = 100).  Returns the worst bf16 error."""
    worst = 0.0
    for dtype in (BF16, F32):
        tag = "bf16" if dtype == BF16 else "fp32"
        for M, K, N in INT8_ANY_K:
            x, w, s, b = _int8_dense_inputs(M, K, N, dtype, gen, zero_row=True)
            check(is_k_major(w) and w.stride(1) == padded_k(K),
                  f"dense_int8 K={K}: the weight is not laid out in padded_k(K) rows")
            _check_codes(f"dense_int8 {tag} M={M} K={K}", x)
            want = dense_int8_fused_plain(x, w, s, b)
            e = _compare_int8(f"dense_int8 {tag} M={M} {K}->{N} zero row",
                              dense_int8_fused(x, w, s, b), want, dtype)
            codes, scales = dense_int8_quantize(x)
            _compare_int8(f"dense_int8 {tag} M={M} {K}->{N} two launches apart",
                          dense_int8_gemm(codes, scales, w, s, b, dtype), want, dtype)
            w_row = w.contiguous()
            _compare_int8(f"dense_int8 {tag} M={M} {K}->{N} row-major kernel_q",
                          dense_int8_fused(x, w_row, s, b), want, dtype)
            if dtype == BF16:
                worst = max(worst, e)
            del x, w, s, b, want, codes, scales, w_row
        M, K, N = INT8_FAULT
        x, w, s, b = _int8_dense_inputs(M, K, N, dtype, gen)
        want = dense_int8_fused_plain(x, w, s, b)
        e = _compare_int8(f"dense_int8 {tag} M={M} {K}->{N}", dense_int8_fused(x, w, s, b), want,
                          dtype)
        q, sx = quantize_rows(x)
        cut = K // 16 * 16
        q[:, cut:] = 0
        _int8_limit_rejects(f"dense_int8 {tag} M={M} {K}->{N} without the last partial K step "
                            f"(codes {cut}-{K - 1})", want,
                            _dequant_plain(q, sx, w, s, b, dtype), dtype)
        if dtype == BF16:
            worst = max(worst, e)
        del x, w, s, b, want, q, sx
    return worst


def _int8_wide_engine(label: str, cfg: STonKGsConfig, params: dict, feats: dict) -> dict:
    """(c) ``quantize_params`` on seeded parameters of a 2-layer config,
    then ``STonKGsEngine.embed`` in bf16 on the card, counts from 0 just
    before it; then, under the phase's limits at full depth (at 2,560 wide
    a code that flips between the card's and the CPU's fp32 inputs moves
    the end-to-end cosine to 0.9996 in 2 layers), card fp32 vs CPU fp32
    (both int8, 4 rows) layer by layer (:func:`_int8_layers_card_vs_cpu`:
    cosine 0.9999 and the flipped codes' share a layer) and end to end
    (cosine 0.999), and card bf16 vs CPU fp32 (0.99).  Returns the launch
    counts."""
    t0 = time.perf_counter()
    params_q = quantize_params(params_to(params, DEV))
    engine = STonKGsEngine(cfg=cfg, params=params_to(params_q, DEV, BF16), batch_size=BATCH,
                           device=DEV)
    _check_k_major(f"{label} int8 engine", engine.params)
    n = len(feats["input_ids"])
    _reset_counts(INT8_SERVING_KERNELS)
    out = engine.embed(feats)
    counts = _counts(INT8_SERVING_KERNELS)
    n_batches, layers = math.ceil(n / BATCH), cfg.bert.num_hidden_layers
    per_batch = {"dense_int8": 6 * 2 * layers, "flash_attention_infer": 2 * layers - 1,
                 "ffn_ln_block": 0}
    log(f"# launches int8 {label} embed ({n_batches} batches): {counts}")
    check(out.shape == (n, cfg.bert.hidden_size) and bool(np.isfinite(out).all()),
          f"int8 {label} embed output {out.shape} not finite")
    for name, c in per_batch.items():
        check(counts[name] == c * n_batches,
              f"int8 {label} {name}: {counts[name]} launches, expected {c} x {n_batches}")
    few = {k: v[:4] for k, v in feats.items()}

    def embed32(p, device):
        return STonKGsEngine(cfg=cfg, params=p, compute_dtype="float32", batch_size=4,
                             device=device).embed(few)

    cpu32 = _int8_layers_card_vs_cpu(lambda p: embed32(p, "cpu"), params_q)
    card32 = embed32(params_q, DEV)
    cos32, cos16 = _cosine(card32, cpu32), _cosine(out[:4], cpu32)
    log(f"# int8 {label}: card fp32 vs CPU fp32 (4 rows, {layers} layers end to end) cosine "
        f"{cos32.tolist()!r} (limit 0.999), max_abs_err {float(np.abs(card32 - cpu32).max())!r}; "
        f"card bf16 vs CPU fp32 cosine {cos16.tolist()!r} (limit 0.99); "
        f"{time.perf_counter() - t0:.1f} s")
    check(bool((cos32 >= 0.999).all()), f"int8 {label}: card fp32 disagrees with the CPU")
    check(bool((cos16 >= 0.99).all()), f"int8 {label}: card bf16 too far from the CPU fp32")
    return counts


def _int8_wide(gen) -> dict:
    """(c) The int8 dense at any K (:func:`_int8_any_k`), the int8 engines at
    the configs of INT8_WIDE_CFGS (:func:`_int8_wide_engine`) and the
    dense at INT8_K100 timed for the kernel line.  Returns the 100-wide
    engine's launch counts, every engine's counts summed, the worst bf16
    error and the K=100 times."""
    t0 = time.perf_counter()
    err = _int8_any_k(gen)
    log(f"# int8 (c) any K: {time.perf_counter() - t0:.1f} s")
    total, k100 = {}, None
    for hidden, heads, inter in INT8_WIDE_CFGS:
        cfg = STonKGsConfig(bert=BertConfig(hidden_size=hidden, num_hidden_layers=2,
                                            num_attention_heads=heads,
                                            intermediate_size=inter),
                            kg_vocab_size=WIDEST_ENTITIES)
        params = _stonkgs_params(cfg, seed=hidden)
        counts = _int8_wide_engine(f"{hidden}-wide", cfg, params,
                                   _features(cfg, ROWS, seed=hidden))
        k100 = k100 or counts
        _add_counts(total, counts)
        del params
        torch.cuda.empty_cache()
    label, M, K, N = INT8_K100
    t = _time_int8_shape(label, M, K, N, gen)
    log(f"# int8 (c) any K, the engines, K=100 timed: {time.perf_counter() - t0:.1f} s")
    return {"counts": k100, "total": total, "err": max(err, t["max_abs_err"]), "time": t}


def phase_int8_serving(cfg: STonKGsConfig, params: dict, feats: dict) -> tuple:
    """``quantize_params`` on phase 5's fp32 parameters (KG table
    included), then ``STonKGsEngine.embed`` in bf16 on the card: the
    int8 main path, counts from 0 just before it.  Then card fp32 vs CPU
    fp32 (both int8) on 4 rows, card bf16 vs CPU fp32, and pairs/s in
    turns with the bf16 engine.  Then (c), the int8 dense at any K
    (:func:`_int8_wide`).  Returns the launch counts and (c)'s results.

    End to end, the 0.9999 cosine holds at 2 layers a stack (full
    width).  At full depth a code that flips in one layer (the card's
    and the CPU's fp32 inputs of a dense straddling a rounding boundary)
    moves every later layer's input, so there the end-to-end cosine is
    logged, held only at 0.999 against gross faults, and the precision
    is held layer by layer (:func:`_int8_layers_card_vs_cpu`)."""
    t0 = time.perf_counter()
    params_q = quantize_params(params_to(params, DEV))
    engine = STonKGsEngine(cfg=cfg, params=params_to(params_q, DEV, BF16), batch_size=BATCH,
                           device=DEV)
    log(f"# int8 serving setup (quantize on the card): {time.perf_counter() - t0:.1f} s")
    _check_k_major("STonKGs int8 engine", engine.params)
    _reset_counts(INT8_SERVING_KERNELS)
    out = engine.embed(feats)
    counts = _counts(INT8_SERVING_KERNELS)
    n_batches = math.ceil(ROWS / BATCH)
    layers = cfg.bert.num_hidden_layers
    # 6 denses a layer: the backbone's L layers, the trunk's L - 1 full
    # layers and its [CLS] layer; attention in every full layer
    per_batch = {"dense_int8": 6 * 2 * layers, "flash_attention_infer": 2 * layers - 1,
                 "ffn_ln_block": 0}
    log(f"# launches int8 parity embed ({n_batches} batches): {counts}")
    check(out.shape == (ROWS, cfg.bert.hidden_size), f"int8 embed shape {out.shape}")
    check(bool(np.isfinite(out).all()), "int8 embed output not finite")
    for name, c in per_batch.items():
        check(counts[name] == c * n_batches,
              f"{name}: {counts[name]} launches, expected {c} x {n_batches}")

    # numerics on 4 rows: card fp32 vs CPU fp32 (both int8) at 2 layers a
    # stack of the full width, then at full depth layer by layer and end
    # to end, and card bf16 vs CPU fp32
    few = {k: v[:4] for k, v in feats.items()}

    def embed32(p, device, c=cfg):
        return STonKGsEngine(cfg=c, params=p, compute_dtype="float32", batch_size=4,
                             device=device).embed(few)

    small = cfg.replace(bert=dataclasses.replace(cfg.bert, num_hidden_layers=2))
    q2 = {**params_q, **{k: {**params_q[k], "encoder": params_q[k]["encoder"][:2]}
                         for k in ("trunk", "lm_backbone")}}
    cos2 = _cosine(embed32(q2, DEV, small), embed32(params_to(q2, "cpu"), "cpu", small))
    log(f"# int8 card fp32 vs CPU fp32 (4 rows, 2 layers a stack): cosine {cos2.tolist()!r} "
        f"(limit 0.9999)")
    check(bool((cos2 >= 0.9999).all()), "int8 card fp32 disagrees with the CPU (2 layers)")
    cpu32 = _int8_layers_card_vs_cpu(lambda p: embed32(p, "cpu"), params_q)
    card32 = embed32(params_q, DEV)
    cos32, cos16 = _cosine(card32, cpu32), _cosine(out[:4], cpu32)
    log(f"# int8 card fp32 vs CPU fp32 (4 rows, {layers} layers end to end): cosine "
        f"{cos32.tolist()!r}, max_abs_err {float(np.abs(card32 - cpu32).max())!r} "
        f"(limit 0.999)")
    log(f"# int8 card bf16 vs CPU fp32 (4 rows, {layers} layers end to end): cosine "
        f"{cos16.tolist()!r} (limit 0.99)")
    check(bool((cos32 >= 0.999).all()), "int8 card fp32 disagrees with the CPU")
    check(bool((cos16 >= 0.99).all()), "int8 card bf16 too far from the CPU fp32")
    del params_q, q2, card32
    bf16 = STonKGsEngine(cfg=cfg, params=params_to(params, DEV, BF16), batch_size=BATCH,
                         device=DEV)
    outs = _time_embed_in_turns("STonKGs parity", {"bf16": bf16, "int8": engine}, feats,
                                "pairs/s")
    cos = _cosine(outs["int8"], outs["bf16"])
    log(f"# int8 vs bf16 embeddings ({ROWS} rows, random weights, not gated): cosine mean "
        f"{float(cos.mean())!r} min {float(cos.min())!r}")
    del engine, bf16, outs
    torch.cuda.empty_cache()
    return counts, _int8_wide(torch.Generator(device=DEV).manual_seed(16))


def _check_k_major(name: str, params) -> None:
    """Every quantized dense of an engine's parameters holds its weight
    column-major on the card (rows of W^T padded_k(K) codes apart), so the
    timed path never copies W."""
    leaves = []
    tree_map(lambda p: leaves.append(p) or p, params, is_leaf=is_quantized)
    dense = [p["kernel_q"] for p in leaves if is_quantized(p)]
    bad = sum(1 for w in dense if w.device.type != "cuda" or not is_k_major(w))
    log(f"# {name}: {len(dense)} quantized weights, {bad} not column-major on the card")
    check(bool(dense) and bad == 0, f"{name}: a quantized weight is not column-major")


@contextlib.contextmanager
def _wrapped(module, name: str, wrap):
    """``module.name`` replaced by ``wrap(module.name)`` for the block."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _recording_codes(store: list):
    """A wrapper of ``dense_int8`` that keeps each input's row codes."""
    def wrap(fn):
        def run(x, p):
            store.append(quantize_rows(x)[0].cpu())
            return fn(x, p)
        return run
    return wrap


def _int8_layers_card_vs_cpu(embed_cpu, params_q: dict) -> np.ndarray:
    """Card vs CPU, one encoder layer at a time, at full depth.

    ``embed_cpu(params)`` runs the int8 model in fp32 on the CPU; every
    encoder layer it runs (the backbone's, the trunk's and its [CLS]
    layer) is kept with its input, its output and the row codes of each
    of its denses' inputs.  Each layer then runs again on the card from
    the CPU's input, in fp32 and in bf16 (the control).  Per layer: the
    least cosine over tokens and the share of codes that differ from the
    CPU's.  fp32 must keep every layer's cosine at 0.9999 and its flips
    under :data:`INT8_FLIP_LIMIT`; the bf16 control must exceed that
    limit, or the count could not tell fp32 from bf16.  Returns the CPU's
    embeddings."""
    calls, codes = [], []

    def record(fn):
        def run(x, lp, c, bias, **kw):
            start = len(codes)
            y = fn(x, lp, c, bias, **kw)
            calls.append((fn, x, lp, c, bias, kw, y, codes[start:]))
            return y
        return run

    with _wrapped(bert, "encoder_layer", record), _wrapped(bert, "encoder_layer_cls", record), \
            _wrapped(bert, "dense_int8", _recording_codes(codes)):
        cpu32 = embed_cpu(params_to(params_q, "cpu"))
    del codes
    rows = {"fp32": [], "bf16": []}
    for fn, x, lp, c, bias, kw, want, want_codes in calls:
        for tag, dtype in (("fp32", F32), ("bf16", BF16)):
            got_codes = []
            with _wrapped(bert, "dense_int8", _recording_codes(got_codes)):
                got = fn(x.to(DEV, dtype), params_to(lp, DEV, dtype), c,
                         None if bias is None else bias.to(DEV), **kw)
            check(len(got_codes) == len(want_codes), "layer runs a different number of denses")
            flips = sum(int((g != w).sum()) for g, w in zip(got_codes, want_codes))
            n = sum(w.numel() for w in want_codes)
            H = want.shape[-1]
            cos = _cosine(got.float().cpu().reshape(-1, H).numpy(), want.reshape(-1, H).numpy())
            rows[tag].append((float(cos.min()), flips / n, flips, n))
    for tag, r in rows.items():
        log(f"# int8 card {tag} vs CPU fp32, each of {len(r)} layers fed the CPU's input "
            f"(backbone, then trunk): least cosine over tokens {[c for c, *_ in r]!r}; "
            f"codes flipped {[f for _, _, f, _ in r]!r} of {[n for *_, n in r]!r}")
    worst_cos = min(c for c, *_ in rows["fp32"])
    worst_flip = max(f for _, f, *_ in rows["fp32"])
    least_flip16 = min(f for _, f, *_ in rows["bf16"])
    log(f"# int8 layer by layer: fp32 least cosine {worst_cos!r} (limit 0.9999), most "
        f"flipped share {worst_flip!r} (limit {INT8_FLIP_LIMIT}); bf16 control least flipped "
        f"share {least_flip16!r} (must exceed the limit)")
    check(worst_cos >= 0.9999, "an int8 layer on the card in fp32 disagrees with the CPU")
    check(worst_flip <= INT8_FLIP_LIMIT, "an int8 layer on the card flips too many codes")
    check(least_flip16 > INT8_FLIP_LIMIT, "the flip count does not tell fp32 from bf16")
    return cpu32


def phase_prot_int8_serving(cfg: ProtSTonKGsConfig, params: dict, bf16_engine, feats) -> dict:
    """``ProtSTonKGsEngine.embed`` with quantized parameters at full
    width (B=8, 32 rows): the int8 main path, counts from 0 just before
    it; then at 2 layers a stack card fp32 and bf16 vs CPU fp32 (all
    int8), and sequences/s in turns with the bf16 engine.  Returns the
    launch counts."""
    t0 = time.perf_counter()
    engine = ProtSTonKGsEngine(cfg=cfg, params=params_to(quantize_params(params_to(params, DEV)),
                                                         DEV, BF16),
                               batch_size=PROT_BATCH, device=DEV)
    log(f"# ProtSTonKGs int8 serving setup: {time.perf_counter() - t0:.1f} s")
    _check_k_major("ProtSTonKGs int8 engine", engine.params)
    _reset_counts(PROT_INT8_SERVING_KERNELS)
    out = engine.embed(feats)
    counts = _counts(PROT_INT8_SERVING_KERNELS)
    n_batches = math.ceil(PROT_ROWS / PROT_BATCH)
    t, lm, prot = cfg.trunk, cfg.lm, cfg.prot
    # 6 denses a layer in the LM and protein backbones and the trunk (its
    # [CLS] layer included), and the protein projection
    per_batch = {"dense_int8": 6 * (lm.num_hidden_layers + prot.num_hidden_layers
                                    + t.num_hidden_layers) + 1,
                 "flash_attention_infer": lm.num_hidden_layers + prot.num_hidden_layers,
                 "bigbird_mid_fwd": t.num_hidden_layers - 1, "ffn_ln_block": 0}
    log(f"# launches ProtSTonKGs int8 embed ({n_batches} batches of {PROT_BATCH}): {counts}")
    check(out.shape == (PROT_ROWS, t.hidden_size), f"ProtSTonKGs int8 embed shape {out.shape}")
    check(bool(np.isfinite(out).all()), "ProtSTonKGs int8 embed output not finite")
    for name, c in per_batch.items():
        check(counts[name] == c * n_batches,
              f"{name}: {counts[name]} launches, expected {c} x {n_batches}")

    small = _prot_cfg(cfg.kg_vocab_size, layers=2)
    q32 = quantize_params(params_to(_prot_params(small, seed=11), DEV))
    few = _prot_features(small, 2, seed=1)
    card32 = ProtSTonKGsEngine(cfg=small, params=q32, compute_dtype="float32", batch_size=2,
                               device=DEV).embed(few)
    card16 = ProtSTonKGsEngine(cfg=small, params=params_to(q32, DEV, BF16), batch_size=2,
                               device=DEV).embed(few)
    cpu32 = ProtSTonKGsEngine(cfg=small, params=params_to(q32, "cpu"), compute_dtype="float32",
                              batch_size=2, device="cpu").embed(few)
    cos32, cos16 = _cosine(card32, cpu32), _cosine(card16, cpu32)
    log(f"# ProtSTonKGs int8 card fp32 vs CPU fp32 (2 rows, 2 layers a stack): cosine "
        f"{cos32.tolist()!r}, max_abs_err {float(np.abs(card32 - cpu32).max())!r} "
        f"(limit: cosine 0.9999)")
    log(f"# ProtSTonKGs int8 card bf16 vs CPU fp32: cosine {cos16.tolist()!r} (limit 0.99)")
    check(bool((cos32 >= 0.9999).all()), "ProtSTonKGs int8 card fp32 disagrees with the CPU")
    check(bool((cos16 >= 0.99).all()), "ProtSTonKGs int8 card bf16 too far from the CPU fp32")
    del q32
    outs = _time_embed_in_turns("ProtSTonKGs", {"bf16": bf16_engine, "int8": engine}, feats,
                                "sequences/s")
    cos = _cosine(outs["int8"], outs["bf16"])
    log(f"# ProtSTonKGs int8 vs bf16 embeddings (random weights, not gated): cosine mean "
        f"{float(cos.mean())!r} min {float(cos.min())!r}")
    return counts


def _time_int8_shape(label: str, M: int, K: int, N: int, gen) -> dict:
    """The int8 dense at one path shape, held against its plain version
    there, then timed beside its bound, its plain version, its two
    launches apart (each beside its own bound) and two references:
    ``torch._int_mm`` on the padded codes (M, Kp) and the padded
    column-major weight (the GEMM alone; cuBLAS takes K a multiple of 8,
    Kp = padded_k(K) is one) and the bf16 dense ``x @ W + b`` that the int8
    mode replaces."""
    x, w, s, b = _int8_dense_inputs(M, K, N, BF16, gen)
    Kp = padded_k(K)
    bound, by = _bound_ms(2.0 * M * K * N, M * K * 2 + K * N + 2 * N * 4 + M * N * 2, I8)
    pass_bound, _ = _bound_ms(0.0, M * K * 2 + M * K + M * 4, I8)
    gemm_bound, gemm_by = _bound_ms(2.0 * M * K * N,
                                    M * K + M * 4 + K * N + 2 * N * 4 + M * N * 2, I8)
    err = _compare(f"dense_int8 bf16 {label} M={M} {K}->{N}", dense_int8_fused(x, w, s, b),
                   dense_int8_fused_plain(x, w, s, b), BF16)
    codes, scales = dense_int8_quantize(x)
    codes_p = F.pad(codes, (0, Kp - K)).contiguous()      # (M, Kp), zero past K
    w_p = torch.as_strided(w, (Kp, N), (1, Kp))            # k_major's padded (Kp, N)
    wb, bb = (w.float() * s).to(BF16), b.to(BF16)
    t = dict(max_abs_err=err, ms=_time_ms(lambda: dense_int8_fused(x, w, s, b)),
             plain_ms=_time_ms(lambda: dense_int8_fused_plain(x, w, s, b), iters=3),
             bound_ms=bound, bound_by=by, library_ms=None,
             pass_ms=_time_ms(lambda: dense_int8_quantize(x)), pass_bound_ms=pass_bound,
             gemm_ms=_time_ms(lambda: dense_int8_gemm(codes, scales, w, s, b, BF16)),
             gemm_bound_ms=gemm_bound, gemm_bound_by=gemm_by,
             floor_ms=pass_bound + gemm_bound,
             int_mm_ms=_time_ms(lambda: torch._int_mm(codes_p, w_p)),
             bf16_dense_ms=_time_ms(lambda: x @ wb + bb))
    log(f"# time dense_int8 {label} M={M} {K}->{N} bf16: {json.dumps(t)}")
    log(f"# rate dense_int8 {label}: {2.0 * M * K * N / (t['ms'] * 1e-3) / 1e12!r} TOP/s; "
        f"GEMM alone {2.0 * M * K * N / (t['gemm_ms'] * 1e-3) / 1e12!r} TOP/s; "
        f"{t['ms'] / t['floor_ms']!r} x the floor, {t['ms'] / t['bf16_dense_ms']!r} x the "
        f"bf16 dense")
    return t


def phase_int8_timing():
    """The int8 dense at each path shape (held against its plain version
    there, then timed) beside its bound, its plain version and two
    references: ``torch._int_mm`` on codes made beforehand and the
    column-major weight (the GEMM alone) and the bf16 dense ``x @ W + b``
    that the int8 mode replaces; then its two launches apart, the
    row-quantize pass and the GEMM, each beside its own bound, whose sum
    is the two-pass design's floor.  Then the probe's ``main`` at 4096^3,
    counts from 0 just before it.  Returns the per-shape numbers, the
    probe's kernel-line numbers and its launch count."""
    gen = torch.Generator(device=DEV).manual_seed(21)
    result = {label: _time_int8_shape(label, M, K, N, gen)
              for label, (M, K, N) in INT8_SHAPES.items()}
    ops = bench_int8_gemm.operands(GEMM_SIZE, GEMM_SIZE, GEMM_SIZE)
    err = _gemm_int8_err(ops["a8"], ops["b8"])
    check(err == 0, "int8_gemm: int8 result differs from its plain version")
    int8_gemm.launches = 0
    try:
        variants = bench_int8_gemm.main(GEMM_SIZE)
    except RuntimeError as e:
        raise SmokeFailure(f"int8 GEMM probe: {e}") from e
    launches = int8_gemm.launches
    log(f"# launches int8 GEMM probe main: {launches}")
    check(launches > 0, "the probe launched no kernel")
    n = GEMM_SIZE
    bound, by = _bound_ms(2.0 * n ** 3, 2 * n * n + 4 * n * n, I8)
    gemm = dict(max_abs_err=err, ms=variants["kernel int8"]["ms"],
                plain_ms=_time_ms(lambda: int8_gemm_plain(ops["a8"], ops["b8"]), iters=3),
                bound_ms=bound, bound_by=by, library_ms=variants["torch int8"]["ms"])
    log(f"# time int8_gemm {n}^3 int8: {json.dumps(gemm)}")
    return result, gemm, launches


# the README flow's files: a BERT-base checkpoint, a vocabulary of
# BioBERT's size with its special ids, node2vec TSVs of 5,000 entities
# (the published KG has more; 5,000 keeps the TSV near 75 MB) at dim 768
# and walks of 127 (the 256 + 256 layout), 512 rows of evidence
README_ENTITIES = 5_000
README_RW_LEN = 127
README_UNKNOWN = 8      # rows whose source is not in the KG (the UNK walk)


def _readme_vocab(size: int, rng: np.random.Generator) -> list:
    """A vocabulary of ``size`` lines with BioBERT's special ids (PAD 0,
    UNK 100, CLS 101, SEP 102, MASK 103), punctuation and digits,
    four-letter roots and two- and three-letter ``##`` pieces, so that a
    root with a suffix tokenizes to two word pieces."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    tokens = [f"[unused{i}]" for i in range(104)]
    tokens[0], tokens[100:104] = "[PAD]", ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tokens += list(".,;:()-/") + [str(d) for d in range(10)]
    pieces = ["##" + "".join(p) for n in (2, 3) for p in itertools.product(letters, repeat=n)]
    pieces = pieces[:4_000]
    roots = ["".join(p) for p in itertools.product(letters, repeat=4)]
    roots = [roots[i] for i in rng.permutation(len(roots))[: size - len(tokens) - len(pieces)]]
    return tokens + roots + pieces


def _readme_rows(names: list, vocab: list, rng: np.random.Generator):
    """ROWS (source, target, evidence) rows: evidence of 10..256 word
    pieces (capitals, punctuation, roots with suffixes), sources and
    targets from ``names``, the first README_UNKNOWN sources unknown."""
    roots = [t for t in vocab[122:] if not t.startswith("##")]
    suffixes = [t[2:] for t in vocab if t.startswith("##")]
    evidences = []
    for want in rng.integers(10, 257, ROWS):
        words, n = [], 0
        while n < want:
            w = roots[rng.integers(len(roots))]
            if rng.random() < 0.3:
                w, n = w + suffixes[rng.integers(len(suffixes))], n + 1
            if rng.random() < 0.1:
                w = w.capitalize()
            if rng.random() < 0.05:
                w, n = f"({w})", n + 2
            words.append(w)
            n += 1
        evidences.append(" ".join(words))
    src = [names[i] for i in rng.integers(0, len(names), ROWS)]
    tgt = [names[i] for i in rng.integers(0, len(names), ROWS)]
    for i in range(README_UNKNOWN):
        src[i] = f"p(HGNC:{90_000 + i} ! NOT_IN_KG{i})"
    return src, tgt, evidences


def _bel_names(n: int) -> list:
    kinds = ("p(HGNC:{i} ! GENE{i})", 'a(CHEBI:"compound {i}")',
             'bp(GO:"cell death {i}")', "complex(p(HGNC:{i}), p(HGNC:{j}))")
    return [kinds[i % 4].format(i=i, j=i + 1) for i in range(n)]


def _timed(fn, runs: int = 3):
    """(last result, seconds of each run), each run ending synchronised."""
    seconds = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return out, seconds


def _rate(label: str, n: int, seconds: list, unit: str, card: str) -> None:
    log(f"# readme {label}: {n} rows, seconds {seconds!r}; best {n / min(seconds)!r} "
        f"{unit}, median {n / statistics.median(seconds)!r} {unit} ({card})")


def phase_readme(card: str) -> dict:
    """The README flow from files: a checkpoint written by the port's
    ``save_pretrained`` from seeded random parameters, a vocabulary and
    node2vec TSVs, all in a temporary directory removed at the end; then
    ``STonKGsEngine.from_pretrained`` on the card, ``preprocess``,
    ``embed`` (parity, then ``length_buckets``), counts from 0 just
    before the parity embed.  Checks the native tokenizer, its features
    against the Python tokenizer's, the loaded parameters and KG table
    bit for bit against those saved, and the embeddings against an
    engine built from the parameters in memory (bf16 on every row, fp32
    on a few).  Returns the parity embed's launch counts."""
    rng = np.random.default_rng(19)
    cfg = STonKGsConfig(bert=BertConfig(), kg_vocab_size=README_ENTITIES)
    with tempfile.TemporaryDirectory(prefix="stonkgs_readme_") as tmp:
        t0 = time.perf_counter()
        params = stonkgs.init_stonkgs_params(torch.Generator().manual_seed(19), cfg)
        ckpt = save_pretrained(params, cfg, os.path.join(tmp, "ckpt"))
        art = make_random_artifacts(README_ENTITIES, dim=cfg.bert.hidden_size,
                                    rw_len=README_RW_LEN, seed=19)
        art.names = _bel_names(README_ENTITIES)
        art.name_to_idx = {n: i for i, n in enumerate(art.names)}
        emb, walks = os.path.join(tmp, "emb.tsv"), os.path.join(tmp, "walks.tsv")
        save_kg_artifacts(art, emb, walks)
        vocab = _readme_vocab(cfg.bert.vocab_size, rng)
        vocab_file = os.path.join(tmp, "vocab.txt")
        with open(vocab_file, "w") as f:
            f.write("\n".join(vocab) + "\n")
        src, tgt, ev = _readme_rows(art.names, vocab, rng)
        sizes = {n: os.path.getsize(os.path.join(tmp, p)) for n, p in (
            ("pytorch_model.bin", "ckpt/pytorch_model.bin"), ("emb.tsv", "emb.tsv"),
            ("walks.tsv", "walks.tsv"), ("vocab.txt", "vocab.txt"))}
        log(f"# readme files written in {time.perf_counter() - t0:.1f} s: {sizes} bytes; "
            f"{README_ENTITIES} entities (cut from the published KG's), dim "
            f"{cfg.bert.hidden_size}, rw_len {README_RW_LEN}, vocabulary {len(vocab)}")

        # the README flow; the tokenizer's library is built (g++) at its
        # first use in a checkout, timed here on its own
        t0 = time.perf_counter()
        check(fast_tokenizer._load_lib() is not None, "the native tokenizer did not build")
        log(f"# readme tokenizer build (g++, first use): {time.perf_counter() - t0!r} s")
        engine, t_load = _timed(lambda: STonKGsEngine.from_pretrained(
            ckpt, emb, walks, vocab_file=vocab_file, batch_size=BATCH), runs=1)
        log(f"# readme from_pretrained: {t_load[0]!r} s ({card})")
        check(engine.tokenizer.is_native, "the native tokenizer did not load on the card")
        check(engine.cfg == cfg, f"loaded config {engine.cfg} differs from {cfg}")
        feats, t_pre = _timed(lambda: engine.preprocess(src, tgt, ev))
        _rate("preprocess (host)", ROWS, t_pre, "rows/s", card)
        _reset_counts(SERVING_KERNELS)
        out = engine.embed(feats)
        counts = _counts(SERVING_KERNELS)
        n_batches = math.ceil(ROWS / BATCH)
        per_batch = cfg.bert.num_hidden_layers * 2 - 1
        log(f"# launches readme parity embed ({n_batches} batches): {counts}")
        check(out.shape == (ROWS, cfg.bert.hidden_size), f"readme embed shape {out.shape}")
        check(bool(np.isfinite(out).all()), "readme embed output not finite")
        for name, c in counts.items():
            check(c == per_batch * n_batches,
                  f"readme {name}: {c} launches, expected {per_batch} x {n_batches}")
        bucketed = dataclasses.replace(engine, length_buckets=BUCKETS)
        _reset_counts(SERVING_KERNELS)
        out_b = bucketed.embed(feats)
        log(f"# launches readme bucketed embed: {_counts(SERVING_KERNELS)}")
        check(all(c > 0 for c in _counts(SERVING_KERNELS).values()),
              "readme bucketed embed skipped a kernel")
        check(bool(np.isfinite(out_b).all()), "readme bucketed embed not finite")

        # the native tokenizer's features against the Python tokenizer's
        py = preprocess_for_embeddings(
            np.asarray(src, object), np.asarray(tgt, object), ev, engine.artifacts,
            BertTokenizer(vocab_file), sep_id=cfg.sep_id, unk_id=cfg.unk_id,
            mask_id=cfg.mask_id)
        check(feats.keys() == py.keys(), "preprocess keys differ from the Python path's")
        for k in py:
            check(np.array_equal(feats[k], py[k]), f"preprocess {k} differs from the "
                  "Python tokenizer's")
        text_len = feats["attention_mask"][:, :cfg.text_len].sum(1)
        ent = feats["input_ids"][:, cfg.text_len:]
        ent = np.where(feats["ent_masked_lm_labels"] != -100, feats["ent_masked_lm_labels"],
                       ent)                       # the entity ids before masking
        unk_rows = int((ent[:, :README_RW_LEN] == cfg.unk_id).all(1).sum())
        log(f"# readme features equal the Python tokenizer's; text lengths "
            f"{int(text_len.min())}..{int(text_len.max())} word pieces with CLS and SEP, "
            f"{unk_rows} rows with an UNK source walk")
        check(unk_rows >= README_UNKNOWN, "the unknown sources did not take the UNK walk")

        # the parameters and the KG table, bit for bit, against those saved
        mem = params_to(params, DEV)
        mem["kg_backbone"] = stonkgs.build_kg_table(mem["lm_backbone"], cfg.bert, art.vectors)
        loaded = dict(tree_flatten_with_path(engine.params))
        want = dict(tree_flatten_with_path(mem))
        check(loaded.keys() == want.keys(), "loaded parameter tree differs from the saved one")
        diff = [k for k in want if not torch.equal(loaded[k], want[k])]
        check(not diff, f"loaded parameters differ from those saved: {diff[:5]}")
        log(f"# readme parameters and KG table equal those saved bit for bit "
            f"({len(want)} leaves, {sum(t.numel() for t in want.values())} values)")

        # embeddings against engines built from the parameters in memory
        for label, eng, got in (("parity", engine, out), ("bucketed", bucketed, out_b)):
            ref = dataclasses.replace(eng, params=mem).embed(feats)
            err = float(np.abs(got - ref).max())
            log(f"# readme {label} bf16 vs in-memory engine ({ROWS} rows): max_abs_err {err!r}")
            check(err == 0.0, f"readme {label} bf16 embed differs from the in-memory engine's")
        few = {k: v[:8] for k, v in feats.items()}
        got32 = dataclasses.replace(engine, compute_dtype="float32", batch_size=8).embed(few)
        ref32 = dataclasses.replace(engine, params=mem, compute_dtype="float32",
                                    batch_size=8).embed(few)
        err32 = float(np.abs(got32 - ref32).max())
        log(f"# readme fp32 vs in-memory engine (8 rows): max_abs_err {err32!r}")
        check(err32 == 0.0, "readme fp32 embed differs from the in-memory engine's")
        del mem, params

        # timings: embed alone, then raw rows -> embeddings end to end
        _, t_embed = _timed(lambda: engine.embed(feats))
        _rate("embed alone (parity)", ROWS, t_embed, "pairs/s", card)
        _, t_e2e = _timed(lambda: engine.embed(engine.preprocess(src, tgt, ev)))
        _rate("rows -> embeddings (parity)", ROWS, t_e2e, "rows/s", card)
        _, t_embed_b = _timed(lambda: bucketed.embed(feats))
        _rate("embed alone (bucketed)", ROWS, t_embed_b, "pairs/s", card)
        _, t_e2e_b = _timed(lambda: bucketed.embed(bucketed.preprocess(src, tgt, ev)))
        _rate("rows -> embeddings (bucketed)", ROWS, t_e2e_b, "rows/s", card)
        # where from_pretrained's and preprocess's seconds go, each part
        # again on its own
        sd, t_sd = _timed(lambda: hf_loader.load_state_dict(ckpt), runs=1)
        tree, t_conv = _timed(lambda: hf_loader.stonkgs_params_from_state_dict(sd, cfg), runs=1)
        _, t_art = _timed(lambda: load_kg_artifacts(emb, walks), runs=1)
        _, t_tok = _timed(lambda: FastBertTokenizer(vocab_file), runs=1)
        _, t_dev = _timed(lambda: stonkgs.build_kg_table(
            params_to(tree, DEV)["lm_backbone"], cfg.bert, art.vectors), runs=1)
        log(f"# readme from_pretrained parts: state dict {t_sd[0]!r} s, its conversion "
            f"{t_conv[0]!r} s, KG artifacts {t_art[0]!r} s, vocabulary {t_tok[0]!r} s, to "
            f"the card and the KG table {t_dev[0]!r} s, of {t_load[0]!r} s ({card})")
        del sd, tree
        text = {}
        for threads in (engine.tokenizer.n_threads, 1):
            tok = FastBertTokenizer(vocab_file, n_threads=threads)
            _, text[threads] = _timed(lambda: tok.encode_batch(ev, cfg.text_len))
        src_a, tgt_a = np.asarray(src, object), np.asarray(tgt, object)
        halves, t_ent = _timed(lambda: assemble_entity_half(src_a, tgt_a, engine.artifacts))
        _, t_mask = _timed(lambda: mask_tokens(halves.astype(np.int64), README_ENTITIES,
                                               np.random.default_rng(0)))
        log(f"# readme preprocess parts (median s): encode_batch "
            f"{statistics.median(text[engine.tokenizer.n_threads])!r} on "
            f"{engine.tokenizer.n_threads} threads, {statistics.median(text[1])!r} on 1; "
            f"entity halves {statistics.median(t_ent)!r}; mask_tokens (one half) "
            f"{statistics.median(t_mask)!r}; of {statistics.median(t_pre)!r} ({card})")
        del engine, bucketed
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# fine-tuning: the CV harness, the TransE layout, ProtSTonKGs, the baselines
# ---------------------------------------------------------------------------

ALL_KERNELS = {**SERVING_KERNELS, **TRAINING_KERNELS}
PROT_ALL_KERNELS = {**PROT_SERVING_KERNELS, **PROT_TRAINING_KERNELS}
FT_ROWS = 80          # the STonKGs CV's rows: two folds of 40
FT_BATCH = 8          # FinetuneConfig's batch size
FT_EVAL_BATCH = 64    # and its eval batch size
FT_LABELS = ("increases", "decreases")
# trainable leaves that no classification loss reaches: the trunk reads
# backbone embeddings, not its word embeddings, and the pre-training heads
# take no part (AdamW leaves a leaf without gradient as it was)
FT_UNUSED = ("trunk/embeddings/word_embeddings", "cls/")


def _ft_labels(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.array([FT_LABELS[int(b)] for b in rng.integers(0, 2, n)], object)


def _recording_losses(store: list):
    """A wrapper of ``make_train_step`` whose steps keep each loss."""
    def wrap(make):
        def made(*a, **kw):
            step = make(*a, **kw)

            def run(state, batch):
                state, m = step(state, batch)
                store.append(m["loss"].detach())
                return state, m
            return run
        return made
    return wrap


def _keeping_last(store: list):
    """A wrapper of ``train_classifier`` that keeps the last fold's state."""
    def wrap(fn):
        def run(*a, **kw):
            state, metrics = fn(*a, **kw)
            store[:] = [state]
            return state, metrics
        return run
    return wrap


def _check_counts(label: str, counts: dict, expected: dict) -> None:
    log(f"# launches {label}: {counts}")
    for name, want in expected.items():
        check(counts[name] == want, f"{label}: {name} launched {counts[name]} times, "
              f"expected {want}")


def _check_losses(label: str, losses: list, steps: int) -> list:
    values = [float(v) for v in losses]
    log(f"# {label} losses ({len(values)} steps): {values!r}")
    check(len(values) == steps, f"{label}: {len(values)} steps, expected {steps}")
    check(all(math.isfinite(v) for v in values), f"{label}: a non-finite loss")
    return values


def _finetune_numerics(cfg_full: STonKGsConfig) -> None:
    """(a) ``classification_loss`` and its gradients (trunk and
    classifier) at 2 rows and 2 layers a stack of the full width, hidden
    dropout 0 and attention dropout 0.1 on the same CPU seeds: the card in
    fp32 against the CPU in fp32, then the card in bf16 (the Hopper
    kernels), each leaf by its cosine."""
    bcfg = dataclasses.replace(cfg_full.bert, num_hidden_layers=2, hidden_dropout_prob=0.0)
    cfg = cfg_full.replace(bert=bcfg, num_labels=2)
    gen = torch.Generator().manual_seed(20)
    params = stonkgs.init_stonkgs_params(gen, cfg, with_classifier=True)
    params["kg_backbone"] = torch.randn(cfg.kg_table_size, bcfg.hidden_size, generator=gen)
    batch = {**_features(cfg, 2, seed=21), "labels": np.array([0, 1])}

    def loss_and_grads(device, dtype=F32):
        p = params_to(params, device)
        named = tree_flatten_with_path({"trunk": p["trunk"], "classifier": p["classifier"]})
        for t in named.values():
            t.requires_grad_(True)
        loss, _ = stonkgs.classification_loss(
            p, cfg, pretraining.to_device(batch, device), deterministic=False,
            rng=pretraining.step_rng(0, 0, device), compute_dtype=dtype)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        return float(loss.detach()), {n: g.detach().cpu() for n, g in zip(named, grads)
                                      if g is not None}

    before = flash_attention_train_bwd.launches
    loss_card, g_card = loss_and_grads(DEV)
    check(flash_attention_train_bwd.launches > before, "the card run launched no kernel")
    loss_cpu, g_cpu = loss_and_grads("cpu")
    check({"classifier/kernel", "classifier/bias"} <= g_cpu.keys(),
          "the classifier's leaves got no gradient")
    check(g_card.keys() == g_cpu.keys(), "card and CPU differ in their gradient leaves")
    err = max(float((g_card[n] - g_cpu[n]).abs().max()) for n in g_cpu)
    scale = max(float(g.abs().max()) for g in g_cpu.values())
    log(f"# finetune card fp32 vs CPU fp32 (2 rows, 2 layers, attention dropout "
        f"{ATTN_RATE}): loss {loss_card!r} vs {loss_cpu!r}; {len(g_cpu)} trunk and "
        f"classifier grads max_abs_err {err!r} of max |grad| {scale!r} (limits: loss 1e-4 "
        f"relative, grads 1e-3 of max |grad|)")
    check(abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu),
          "fine-tuning card loss disagrees with the CPU")
    check(err <= 1e-3 * scale, "fine-tuning card gradients disagree with the CPU")

    loss_bf16, g_bf16 = loss_and_grads(DEV, BF16)
    check(g_bf16.keys() == g_cpu.keys(), "card bf16 and CPU differ in their gradient leaves")
    norm_max = max(float(g.norm()) for g in g_cpu.values())
    cosines = {}
    for n, want in g_cpu.items():
        got, w = g_bf16[n].double().flatten(), want.double().flatten()
        if n.endswith(ZERO_GRAD_LEAVES):
            check(float(w.norm()) <= 1e-6 * norm_max and float(got.norm()) <= 1e-4 * norm_max,
                  f"{n}: a gradient that should cancel reads {float(w.norm())!r} (CPU), "
                  f"{float(got.norm())!r} (card bf16) of the largest leaf norm {norm_max!r}")
            continue
        cosines[n] = float(got @ w / (got.norm() * w.norm()))
    worst = min(cosines, key=cosines.get)
    rel = abs(loss_bf16 - loss_cpu) / abs(loss_cpu)
    log(f"# finetune card bf16 vs CPU fp32: loss {loss_bf16!r} vs {loss_cpu!r} ({rel!r} "
        f"relative; limit 1e-2); {len(cosines)} leaves, lowest cosine {cosines[worst]!r} "
        f"({worst}; limit 0.99); classifier kernel {cosines['classifier/kernel']!r}, bias "
        f"{cosines['classifier/bias']!r}")
    check(rel <= 1e-2, "fine-tuning card bf16 loss disagrees with the CPU")
    check(cosines[worst] >= 0.99, f"fine-tuning card bf16 gradient {worst} disagrees")


def _finetune_cv(cfg: STonKGsConfig, params: dict, card: str) -> dict:
    """(b) ``run_sequence_classification_cv`` at full width on 80 rows:
    2 folds, 1 epoch, B=8, eval B=64, bf16 compute, fp32 parameters on
    the card; the main path, counts from 0 just before it.  Returns its
    counts."""
    feats, labels = _features(cfg, FT_ROWS, seed=22), _ft_labels(FT_ROWS, 22)
    before = tree_map(torch.clone, params)
    run_cfg = finetuning.FinetuneConfig(epochs=1, batch_size=FT_BATCH, cv=2,
                                        eval_batch_size=FT_EVAL_BATCH,
                                        compute_dtype="bfloat16")
    losses, last = [], []
    with tempfile.TemporaryDirectory(prefix="stonkgs_finetune_") as tmp:
        with RunLogger(log_dir=tmp, experiment="smoke", run_name="cv", stdout=False) as logger, \
                _wrapped(finetuning, "make_train_step", _recording_losses(losses)), \
                _wrapped(finetuning, "train_classifier", _keeping_last(last)):
            _reset_counts(ALL_KERNELS)
            t0 = time.perf_counter()
            result = finetuning.run_sequence_classification_cv(
                feats, labels, params, cfg, run_cfg, task_name="smoke", output_dir=tmp,
                logger=logger)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _counts(ALL_KERNELS)
        log(f"# finetune CV ({FT_ROWS} rows, 2 folds, B={FT_BATCH}, bf16): {result} in "
            f"{seconds!r} s, export included ({card})")
        steps = 2 * (FT_ROWS // 2 // FT_BATCH)
        layers = cfg.bert.num_hidden_layers
        _check_counts("finetune CV", counts, {
            "flash_attention_train_fwd": 2 * layers * steps,
            "flash_attention_train_bwd": layers * steps,
            "ffn_train_fwd": 2 * layers * steps, "ffn_train_bwd": layers * steps,
            "ffn_ln_block": (2 * layers - 1) * 2, "flash_attention_infer": (2 * layers - 1) * 2})
        _check_losses("finetune CV", losses, steps)
        with open(os.path.join(tmp, "smoke-cv.jsonl")) as f:
            f1s = [r["value"] for r in map(json.loads, f)
                   if r["type"] == "metric" and r["key"] == "f1_score_weighted"]
        check(len(f1s) == 2 and all(0.0 <= v <= 1.0 for v in f1s), f"fold F1s {f1s}")

        same = [k for k, (a, b) in _paired(params, before) if not torch.equal(a, b)]
        check(not same, f"the pretrained tree passed in changed: {same[:5]}")
        state = last[0]
        trained = tree_flatten_with_path(split_frozen(state.params)[0])
        ref = tree_flatten_with_path(split_frozen(before)[0])
        unchanged = [k for k in ref if torch.equal(trained[k], ref[k])]
        log(f"# finetune trainable leaves unchanged after the last fold: {len(unchanged)} of "
            f"{len(ref)} ({[k for k in unchanged if not k.startswith('cls/')]} and cls/*)")
        check(all(k.startswith(FT_UNUSED) for k in unchanged), "a trainable leaf did not change")
        head = init_classifier_head(torch.Generator().manual_seed(run_cfg.seed + 2),
                                    cfg.bert, len(FT_LABELS))
        check(not torch.equal(trained["classifier/kernel"].cpu(), head["kernel"]),
              "the classifier did not train")

        with open(os.path.join(tmp, "predicted_labels_stonkgs_smokedf.tsv"), newline="") as f:
            rows = list(csv.reader(f, delimiter="\t"))
        check(rows[0] == ["split", "index", "predicted_label", "true_label"],
              f"TSV header {rows[0]}")
        check(len(rows) == 1 + FT_ROWS and sorted(int(r[1]) for r in rows[1:])
              == list(range(FT_ROWS)), "the TSV does not hold every row once")
        check(all(r[2] in FT_LABELS and r[3] in FT_LABELS for r in rows[1:]),
              "a TSV label outside the label set")
        check([r[3] for r in sorted(rows[1:], key=lambda r: int(r[1]))] == list(labels),
              "the TSV's true labels differ from the rows'")

        sd = hf_loader.load_state_dict(os.path.join(tmp, "smoke"))
        back = tree_flatten_with_path(hf_loader.stonkgs_params_from_state_dict(
            sd, cfg.replace(num_labels=len(FT_LABELS))))
        mem = tree_flatten_with_path(state.params)
        diff = [k for k in back if not torch.equal(back[k], mem[k].cpu())]
        log(f"# finetune export read back: {len(back)} leaves, {len(diff)} differ from the "
            f"last fold's parameters")
        check("classifier/kernel" in back and not diff,
              f"the exported model differs from the last fold's: {diff[:5]}")
    del last, state, before
    return counts


def _paired(a: dict, b: dict):
    na, nb = tree_flatten_with_path(a), tree_flatten_with_path(b)
    check(na.keys() == nb.keys(), "the trees differ in their leaves")
    return [(k, (na[k], nb[k])) for k in na]


def _transe_params(params: dict, tcfg: STonKGsConfig) -> dict:
    """The STonKGs parameters with both position tables cut to the TransE
    layout's 260 rows (widths unchanged)."""
    out = dict(params)
    for key in ("trunk", "lm_backbone"):
        emb = dict(params[key]["embeddings"])
        emb["position_embeddings"] = emb["position_embeddings"][
            :tcfg.bert.max_position_embeddings]
        out[key] = {**params[key], "embeddings": emb}
    return out


def _finetune_transe(cfg: STonKGsConfig, params: dict) -> dict:
    """(c) The TransE layout (256 + 4, S=260) at full width: the CV with
    ``cv=1`` (the first of 5 folds), 1 epoch on 40 rows; counts from 0
    just before it."""
    tcfg = STonKGsConfig.transe(cfg.kg_vocab_size,
                                bert=dataclasses.replace(cfg.bert, max_position_embeddings=260))
    tparams = _transe_params(params, tcfg)
    n = 40
    feats, labels = _features(tcfg, n, seed=23), _ft_labels(n, 23)
    run_cfg = finetuning.FinetuneConfig(epochs=1, batch_size=FT_BATCH, cv=1,
                                        eval_batch_size=FT_EVAL_BATCH, compute_dtype="bfloat16")
    losses = []
    with _wrapped(finetuning, "make_train_step", _recording_losses(losses)):
        _reset_counts(ALL_KERNELS)
        result = finetuning.run_sequence_classification_cv(feats, labels, tparams, tcfg, run_cfg)
        torch.cuda.synchronize()
        counts = _counts(ALL_KERNELS)
    log(f"# finetune TransE (S={tcfg.seq_len}, {n} rows, cv=1): {result}")
    steps, layers = (n - n // 5) // FT_BATCH, tcfg.bert.num_hidden_layers
    _check_counts("finetune TransE", counts, {
        "flash_attention_train_fwd": 2 * layers * steps,
        "flash_attention_train_bwd": layers * steps,
        "ffn_train_fwd": 2 * layers * steps, "ffn_train_bwd": layers * steps,
        "ffn_ln_block": 2 * layers - 1, "flash_attention_infer": 2 * layers - 1})
    _check_losses("finetune TransE", losses, steps)
    return counts


def _finetune_prot(pcfg: ProtSTonKGsConfig, pparams: dict) -> dict:
    """(d) ProtSTonKGs at full width: the CV with ``cv=1``, 1 epoch on 20
    rows at B=2 (the training plan), eval B=8; counts from 0 just before
    it; the three backbones bit-unchanged."""
    params = params_to(pparams, DEV)
    frozen_before = tree_map(torch.clone, split_frozen(params)[1])
    n, B = 20, PROT_TRAIN_BATCH
    feats, labels = _prot_features(pcfg, n, seed=24), _ft_labels(n, 24)
    run_cfg = finetuning.FinetuneConfig(epochs=1, batch_size=B, cv=1,
                                        eval_batch_size=PROT_BATCH, compute_dtype="bfloat16")
    losses = []
    with _wrapped(finetuning, "make_train_step", _recording_losses(losses)):
        _reset_counts(PROT_ALL_KERNELS)
        result = finetuning.run_sequence_classification_cv(
            feats, labels, params, pcfg, run_cfg, loss_fn=protstonkgs.classification_loss,
            logits_fn=protstonkgs.classification_logits, trunk_cfg=pcfg.trunk)
        torch.cuda.synchronize()
        counts = _counts(PROT_ALL_KERNELS)
    log(f"# finetune ProtSTonKGs ({n} rows, cv=1, B={B}): {result}")
    steps = (n - n // 5) // B
    t, lm, prot = pcfg.trunk, pcfg.lm, pcfg.prot
    _check_counts("finetune ProtSTonKGs", counts, {
        "bigbird_mid_fwd": t.num_hidden_layers * steps + t.num_hidden_layers - 1,
        "bigbird_mid_bwd": t.num_hidden_layers * steps,
        "ffn_train_fwd": (lm.num_hidden_layers + prot.num_hidden_layers
                          + t.num_hidden_layers) * steps,
        "ffn_train_bwd": t.num_hidden_layers * steps,
        "flash_attention_train_fwd": (lm.num_hidden_layers + prot.num_hidden_layers) * steps,
        "flash_attention_train_bwd": 0,
        "ffn_ln_block": lm.num_hidden_layers + prot.num_hidden_layers
        + t.num_hidden_layers - 1,
        "flash_attention_infer": lm.num_hidden_layers + prot.num_hidden_layers})
    _check_losses("finetune ProtSTonKGs", losses, steps)
    frozen_after = split_frozen(params)[1]
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(frozen_before),
                                                tree_leaves(frozen_after))),
          "a frozen ProtSTonKGs backbone changed")
    return counts


def _nlp_features(bcfg: BertConfig, n: int, seed: int, S: int = 512) -> dict:
    """Evidence-only rows: uniform word pieces, true lengths 10..S."""
    rng = np.random.default_rng(seed)
    keep = np.arange(S)[None, :] < rng.integers(10, S + 1, n)[:, None]
    ids = np.where(keep, rng.integers(4, bcfg.vocab_size, (n, S)), 0)
    return {"input_ids": ids.astype(np.int64), "attention_mask": keep.astype(np.int64)}


def _finetune_nlp(bcfg: BertConfig, lm_params: dict) -> dict:
    """(e) The NLP baseline: BioBERT 12 x 768 (the STonKGs LM backbone's
    parameters) trained with its classifier at S=512, B=16, ``cv=1``, 1
    epoch on 40 rows (2 steps), in fp32 (the default; the fp32 bodies)
    and in bf16; counts from 0 just before each.  Returns their sum."""
    n, B = 40, 16
    feats, labels = _nlp_features(bcfg, n, 25), _ft_labels(n, 25)
    steps, layers = (n - n // 5) // B, bcfg.num_hidden_layers
    total = {}
    for dtype in ("float32", "bfloat16"):
        losses = []
        with _wrapped(nlp_baseline, "make_train_step", _recording_losses(losses)):
            _reset_counts(ALL_KERNELS)
            t0 = time.perf_counter()
            result = nlp_baseline.run_nlp_baseline_cv(
                bcfg, feats, labels, pretrained_bert=lm_params, epochs=1, batch_size=B, cv=1,
                compute_dtype=dtype, device=DEV)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _counts(ALL_KERNELS)
        log(f"# finetune NLP baseline {dtype} ({n} rows, cv=1, B={B}): {result} in "
            f"{seconds!r} s")
        _check_counts(f"finetune NLP baseline {dtype}", counts, {
            "flash_attention_train_fwd": layers * steps,
            "flash_attention_train_bwd": layers * steps,
            "ffn_train_fwd": layers * steps, "ffn_train_bwd": layers * steps,
            "ffn_ln_block": layers, "flash_attention_infer": layers})
        _check_losses(f"finetune NLP baseline {dtype}", losses, steps)
        for name, c in counts.items():
            total[name] = total.get(name, 0) + c
    return total


def _finetune_kg(card: str) -> None:
    """(f) The KG baseline at the reference's defaults (10 epochs, lr
    1e-3): node2vec features (N, 254, 768) of 200 rows over 1,000 random
    entities (vectors N(0, 0.1^2)), on the card, with the class written
    as +-1 into 8 dimensions (a separable task); 2-fold CV, F1 above 0.9."""
    n = 200
    art = make_random_artifacts(1_000, dim=768, rw_len=README_RW_LEN, seed=26)
    art.vectors *= 0.1
    rng = np.random.default_rng(26)
    src = [art.names[i] for i in rng.integers(0, 1_000, n)]
    tgt = [art.names[i] for i in rng.integers(0, 1_000, n)]
    t0 = time.perf_counter()
    x = torch.from_numpy(kg_baseline.build_node2vec_features(art, src, tgt)).to(DEV)
    y = rng.integers(0, 2, n)
    x[:, :, :8] = torch.from_numpy(np.where(y == 1, 1.0, -1.0)).to(DEV, F32)[:, None, None]
    build = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = kg_baseline.run_kg_baseline_cv(x, np.array([FT_LABELS[v] for v in y], object),
                                            cv=2, seed=1)
    torch.cuda.synchronize()
    log(f"# finetune KG baseline: features {tuple(x.shape)} built in {build!r} s; 2-fold CV "
        f"{result} in {time.perf_counter() - t0!r} s ({card})")
    check(result["f1_score_mean"] > 0.9, f"KG baseline F1 {result['f1_score_mean']!r}")


class _TimedAdamW(AdamW):
    """AdamW whose update is timed alone, synchronised on both sides."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.seconds = []

    def update_and_apply(self, grads, state, params, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        super().update_and_apply(grads, state, params, **kw)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)


def _time_steps(label: str, step, state, batch, tx: _TimedAdamW, card: str):
    """The median of 6 steps after 2 of warm-up, each synchronised by its
    loss, split into forward+backward and the optimizer."""
    total = []
    for i in range(2 + 6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        if i >= 2:
            total.append(time.perf_counter() - t0)
        check(math.isfinite(loss), f"{label}: non-finite loss in the timed steps")
    opt = tx.seconds[2:]
    med, med_opt = statistics.median(total), statistics.median(opt)
    B = len(batch["input_ids"])
    log(f"# {label} step B={B} bf16: seconds {total!r}; median {med * 1e3!r} ms, "
        f"{B / med!r} examples/s; forward+backward {(med - med_opt) * 1e3!r} ms, optimizer "
        f"{med_opt * 1e3!r} ms (median of {opt!r} s, synchronised alone); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB ({card})")
    return state


def _finetune_timing(cfg: STonKGsConfig, params: dict, card: str) -> dict:
    """(g) The fine-tuning step at B=8 and the NLP baseline's at B=16,
    ``predict`` at B=64, then the training kernels at fine-tuning's
    shapes beside their bounds, plain versions and library calls.
    Returns per kernel the trunk shape's numbers."""
    ccfg = cfg.replace(num_labels=len(FT_LABELS))
    train, frozen = split_frozen(params)
    train = {k: tree_map(torch.clone, v) for k, v in train.items()}
    train["classifier"] = params_to(init_classifier_head(
        torch.Generator().manual_seed(27), cfg.bert, len(FT_LABELS)), DEV)
    tx = _TimedAdamW(total_steps=1000)
    state = pretraining.init_train_state(merge_frozen(train, frozen), tx)
    step = pretraining.make_train_step(ccfg, tx, loss_fn=stonkgs.classification_loss,
                                       compute_dtype=BF16)
    feats = _features(cfg, 256, seed=28)
    batch = pretraining.to_device({**{k: v[:FT_BATCH] for k, v in feats.items()},
                                   "labels": np.arange(FT_BATCH) % 2}, DEV)
    torch.cuda.reset_peak_memory_stats()
    state = _time_steps("finetune", step, state, batch, tx, card)
    _, seconds = _timed(lambda: finetuning.predict(ccfg, state.params, feats,
                                                   batch_size=FT_EVAL_BATCH))
    log(f"# finetune predict B={FT_EVAL_BATCH} bf16: {len(feats['input_ids'])} rows, seconds "
        f"{seconds!r}; median {len(feats['input_ids']) / statistics.median(seconds)!r} "
        f"sequences/s ({card})")
    del state, step, tx, train

    bcfg = cfg.bert
    nparams = tree_map(lambda t: t.to(DEV, copy=True), nlp_baseline.init_nlp_baseline_params(
        torch.Generator().manual_seed(29), bcfg, 2, pretrained_bert=params["lm_backbone"]))
    tx = _TimedAdamW(total_steps=1000)
    step = pretraining.make_train_step(bcfg, tx, loss_fn=nlp_baseline.classification_loss,
                                       compute_dtype=BF16)
    batch = pretraining.to_device({**_nlp_features(bcfg, 16, 30), "labels": np.arange(16) % 2},
                                  DEV)
    torch.cuda.reset_peak_memory_stats()
    _time_steps("NLP baseline", step, pretraining.init_train_state(nparams, tx), batch, tx,
                card)
    del nparams, step, tx

    gen = torch.Generator(device=DEV).manual_seed(31)
    B, sl, tl = FT_BATCH, cfg.seq_len, cfg.text_len
    cases = [
        ("ffn_train_fwd", f"finetune trunk M={B * sl}",
         lambda lb: _time_train_ffn(lb, B * sl, gen, False)),
        ("ffn_train_bwd", f"finetune trunk M={B * sl}",
         lambda lb: _time_train_ffn(lb, B * sl, gen, True)),
        ("ffn_train_fwd:backbone", f"finetune backbone M={B * tl}",
         lambda lb: _time_train_ffn(lb, B * tl, gen, False)),
        ("flash_attention_train_fwd", f"finetune trunk B={B} S={sl} mask",
         lambda lb: _time_train_attention(lb, B, sl, True, gen, False)),
        ("flash_attention_train_bwd", f"finetune trunk B={B} S={sl} mask",
         lambda lb: _time_train_attention(lb, B, sl, True, gen, True)),
        ("flash_attention_train_fwd:backbone", f"finetune backbone B={B} S={tl} no-bias",
         lambda lb: _time_train_attention(lb, B, tl, False, gen, False)),
    ]
    result = {}
    for key, label, fn in cases:
        t = fn(label)
        log(f"# time {key.split(':')[0]} {label} bf16 ({card}): {json.dumps(t)}")
        result[key] = t
    return result


def phase_finetune(card: str, params: Optional[dict] = None,
                   pparams: Optional[dict] = None):
    """Fine-tuning on the card: (a) numerics, (b) the STonKGs CV, (c) the
    TransE layout, (d) ProtSTonKGs, (e) the NLP baseline, (f) the KG
    baseline, (g) timing.  ``params`` and ``pparams`` are phase 5's and
    phase 11's CPU parameters (made here when not given).  Returns the
    main paths' launch counts, summed, and (g)'s kernel times."""
    t0 = time.perf_counter()
    cfg = STonKGsConfig(bert=BertConfig(), kg_vocab_size=100_000)
    pcfg = _prot_cfg()
    if params is None:
        params = _stonkgs_params(cfg)
    if pparams is None:
        pparams = _prot_params(pcfg, seed=10, dtype=BF16)
    _finetune_numerics(cfg)
    card_params = params_to(params, DEV)      # fp32 parameters on the card
    counts = {}
    for counted in (_finetune_cv(cfg, card_params, card),
                    _finetune_transe(cfg, card_params),
                    _finetune_prot(pcfg, pparams),
                    _finetune_nlp(cfg.bert, params["lm_backbone"])):
        for name, c in counted.items():
            counts[name] = counts.get(name, 0) + c
    _finetune_kg(card)
    times = _finetune_timing(cfg, card_params, card)
    del card_params
    torch.cuda.empty_cache()
    log(f"# finetune phase: {time.perf_counter() - t0:.1f} s")
    return counts, times


# ---------------------------------------------------------------------------
# pre-training from files: run_pretraining over a memmap store, checkpoints,
# resume, the export, the other layouts, dynamic masking, embed_stream
# ---------------------------------------------------------------------------

PF_ROWS = 1024        # rows of the memmap store
PF_STEPS = 6          # steps of the first run, saving every PF_SAVE
PF_SAVE = 3
PF_SHORT_STEPS = 2    # the TransE and ProtSTonKGs runs
PF_PROT_BATCH = 2
PF_DYN_STEPS = 4
PF_CHUNK = 128        # embed_stream's chunk: one batch


def _training_per_step(layers: int) -> dict:
    return {"flash_attention_train_fwd": 2 * layers, "flash_attention_train_bwd": layers,
            "ffn_train_fwd": 2 * layers, "ffn_train_bwd": layers}


def _prot_training_per_step(cfg: ProtSTonKGsConfig) -> dict:
    t, lm, prot = cfg.trunk, cfg.lm, cfg.prot
    return {"bigbird_mid_fwd": t.num_hidden_layers, "bigbird_mid_bwd": t.num_hidden_layers,
            "ffn_train_fwd": lm.num_hidden_layers + prot.num_hidden_layers
            + t.num_hidden_layers,
            "ffn_train_bwd": t.num_hidden_layers,
            "flash_attention_train_fwd": lm.num_hidden_layers + prot.num_hidden_layers}


def _metric_records(output_dir: str) -> list:
    """The metric records of every JSONL run log in ``output_dir``, in order."""
    out = []
    if os.path.isdir(output_dir):
        for name in sorted(os.listdir(output_dir)):
            if name.endswith(".jsonl"):
                with open(os.path.join(output_dir, name)) as f:
                    out += [r for r in map(json.loads, f) if r.get("type") == "metric"]
    return out


def _add_counts(total: dict, counts: dict) -> None:
    for name, c in counts.items():
        total[name] = total.get(name, 0) + c


def _pf_run(label: str, store: str, out_dir: str, kernels: dict, per_step: dict,
            steps: list, total: dict, **kw):
    """``run_pretraining`` with the counts from 0 just before it: checks
    the launches a step and a finite logged loss at exactly ``steps``.
    Returns (state, {step: loss}, seconds, last examples_per_sec)."""
    before = len(_metric_records(out_dir))
    _reset_counts(kernels)
    t0 = time.perf_counter()
    state = run_pretraining(store, output_dir=out_dir, log_steps=1, device=DEV, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _counts(kernels)
    _check_counts(f"{label} ({len(steps)} steps)", counts,
                  {n: c * len(steps) for n, c in per_step.items()})
    _add_counts(total, counts)
    recs = _metric_records(out_dir)[before:]
    losses = {r["step"]: r["value"] for r in recs if r["key"] == "loss"}
    eps = [r["value"] for r in recs if r["key"] == "examples_per_sec"]
    log(f"# {label}: {seconds:.1f} s; losses {losses!r}; examples/s "
        f"{eps[-1] if eps else None!r}")
    check(list(losses) == steps, f"{label}: logged steps {list(losses)}, expected {steps}")
    check(all(math.isfinite(v) for v in losses.values()), f"{label}: a non-finite loss")
    check(state.step == steps[-1], f"{label}: ended at step {state.step}")
    return state, losses, seconds, eps[-1] if eps else None


def _dir_gb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path)
               for f in fs) / 1e9


def _pf_spread(label: str, a, b, la: dict, lb: dict, init: dict) -> tuple:
    """How far run ``a`` is from run ``b``: the largest relative loss gap
    over ``la``'s steps, the lowest cosine of a trainable leaf's update
    (final - init; leaves without a gradient, held equal, and the key
    biases, whose gradient is 0 in exact arithmetic, left out), and
    whether every trainable leaf is equal bit for bit."""
    gap = max(abs(la[s] - lb[s]) / abs(lb[s]) for s in la)
    ta, tb = tree_flatten_with_path(split_frozen(a.params)[0]), tree_flatten_with_path(split_frozen(b.params)[0])
    unequal = {k: float((ta[k] - tb[k]).abs().max()) for k in tb if not torch.equal(ta[k], tb[k])}
    equal = not unequal
    cos = 1.0
    for k, w in tb.items():
        if k.startswith(UNUSED_LEAVES):
            check(torch.equal(ta[k], w), f"{label}: unused leaf {k} differs")
            continue
        if any(z in k for z in ZERO_GRAD_LEAVES):
            continue
        ua, ub = (ta[k] - init[k].to(DEV)).flatten(), (w - init[k].to(DEV)).flatten()
        if torch.equal(ua, ub):
            continue
        c = float(F.cosine_similarity(ua.double(), ub.double(), dim=0))
        cos = min(cos, c if math.isfinite(c) else -1.0)
    log(f"# {label}: largest relative loss gap {gap!r}, lowest update cosine {cos!r}, "
        f"trainable leaves equal bit for bit: {equal} ({len(unequal)} of {len(tb)} differ; "
        f"largest max |diff| {max(unequal.values(), default=0.0)!r} in "
        f"{max(unequal, key=unequal.get, default=None)})")
    return gap, cos, equal


def _pf_files(tmp: str, cfg: STonKGsConfig):
    """(a) The memmap store (PF_ROWS pre-training rows with int(0.15 * 256)
    masked positions a half and NSP labels), phase 19's node2vec TSVs and
    28,996-line vocabulary (the same seeds, so the same files)."""
    t0 = time.perf_counter()
    feats = _pretraining_features(cfg, PF_ROWS, seed=21)
    store_dir = os.path.join(tmp, "store")
    MemmapFeatureStore.write(store_dir, feats)
    rng = np.random.default_rng(19)
    art = make_random_artifacts(README_ENTITIES, dim=cfg.bert.hidden_size,
                                rw_len=README_RW_LEN, seed=19)
    art.names = _bel_names(README_ENTITIES)
    art.name_to_idx = {n: i for i, n in enumerate(art.names)}
    emb, walks = os.path.join(tmp, "emb.tsv"), os.path.join(tmp, "walks.tsv")
    save_kg_artifacts(art, emb, walks)
    vocab = _readme_vocab(cfg.bert.vocab_size, rng)
    vocab_file = os.path.join(tmp, "vocab.txt")
    with open(vocab_file, "w") as f:
        f.write("\n".join(vocab) + "\n")
    rows = _readme_rows(art.names, vocab, rng)
    log(f"# pretrain files written in {time.perf_counter() - t0:.1f} s: store "
        f"{_dir_gb(store_dir)!r} GB ({PF_ROWS} rows, S={cfg.seq_len}), node2vec "
        f"{README_ENTITIES} x {cfg.bert.hidden_size}, vocabulary {len(vocab)}")
    return store_dir, emb, walks, vocab_file, art, rows


def _pf_dynamic(cfg: STonKGsConfig, params: dict, store: MemmapFeatureStore, total: dict):
    """(f) ``pretrain`` with ``dynamic_masking_loss`` on raw features, then
    the masking's statistics on the card over the whole store."""
    raw = {k: np.asarray(store[k][: TRAIN_BATCH * PF_DYN_STEPS])
           for k in ("input_ids", "attention_mask", "token_type_ids")}
    run_cfg = pretraining.PretrainingConfig(max_steps=PF_DYN_STEPS,
                                            micro_batch_size=TRAIN_BATCH, log_steps=1,
                                            compute_dtype="bfloat16")
    logged = []
    _reset_counts(TRAINING_KERNELS)
    pretraining.pretrain(cfg, params, raw, run_cfg, loss_fn=dynamic_masking_loss(),
                         log_fn=lambda step, m: logged.append((step, m["loss"])))
    torch.cuda.synchronize()
    counts = _counts(TRAINING_KERNELS)
    _check_counts(f"pretrain dynamic masking ({PF_DYN_STEPS} steps)", counts,
                  {n: c * PF_DYN_STEPS
                   for n, c in _training_per_step(cfg.bert.num_hidden_layers).items()})
    _add_counts(total, counts)
    _check_losses("pretrain dynamic masking", [v for _, v in logged], PF_DYN_STEPS)

    ids = torch.as_tensor(np.array(store["input_ids"]), dtype=torch.int64, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(21)
    tl = cfg.text_len
    for half, vocab, name in ((ids[:, :tl], cfg.bert.vocab_size, "text"),
                              (ids[:, tl:], cfg.kg_vocab_size, "entity")):
        masked, labels = mask_tokens_torch(gen, half, vocab)
        chosen = labels != -100
        per_row = chosen.sum(1)
        k = int(half.shape[1] * 0.15)
        check(bool((per_row == k).all()), f"mask_tokens_torch {name}: "
              f"{int(per_row.min())}..{int(per_row.max())} positions a row, expected {k}")
        check(torch.equal(labels[chosen], half[chosen]) and
              torch.equal(masked[~chosen], half[~chosen]), f"mask_tokens_torch {name}: labels")
        n = int(chosen.sum())
        is_mask = masked[chosen] == 103
        kept = masked[chosen] == half[chosen]
        shares = {"mask": (float(is_mask.float().mean()), 0.8),
                  "kept": (float(kept.float().mean()), 0.1 + 0.1 / vocab),
                  "random": (float((~is_mask & ~kept).float().mean()), 0.1 - 0.1 / vocab)}
        for what, (share, p) in shares.items():
            sigma = math.sqrt(p * (1 - p) / n)
            log(f"# mask_tokens_torch {name} on the card: {what} share {share!r} of {n} "
                f"(expected {p!r} +- 4 sigma = {4 * sigma!r})")
            check(abs(share - p) <= 4 * sigma, f"mask_tokens_torch {name}: {what} share")
    ent_labels = torch.full((len(ids), ids.shape[1] - tl), -100, dtype=torch.int64, device=DEV)
    out, _, nsp = dynamic_nsp_swap(gen, ids, ent_labels, tl)
    share, sigma = float(nsp.float().mean()), math.sqrt(0.2 * 0.8 / len(ids))
    log(f"# dynamic_nsp_swap on the card: NSP negatives {share!r} of {len(ids)} rows "
        f"(expected 0.2 +- {4 * sigma!r})")
    check(abs(share - 0.2) <= 4 * sigma, "dynamic_nsp_swap: share of negatives")
    check(torch.equal(out[:, :tl], ids[:, :tl])
          and torch.equal(out[nsp == 0], ids[nsp == 0]), "dynamic_nsp_swap: rows changed")


def _pf_step_times(cfg: STonKGsConfig, state, features: dict, card: str) -> None:
    """(h) ms a step at B=32: phase 9's way (one batch on the card) and
    from the memmap store through the prefetch thread, each step
    synchronised by its loss; the median of 6 after 2."""
    tx = AdamW(total_steps=1000)
    step = pretraining.make_train_step(cfg, tx, compute_dtype=BF16)
    fixed = pretraining.to_device({k: np.asarray(v[:TRAIN_BATCH]) for k, v in features.items()},
                                  DEV)
    sources = {
        "in memory (one batch on the card)": itertools.repeat(fixed),
        "from the memmap store (prefetch thread)": pretraining._prefetch_to_device(
            pretraining.data_iterator(features, TRAIN_BATCH, seed=1),
            lambda b: pretraining.to_device(b, DEV), 8),
    }
    for label, batches in sources.items():
        times = []
        for i in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, next(batches))
            loss = float(m["loss"])
            if i >= 2:
                times.append(time.perf_counter() - t0)
            check(math.isfinite(loss), "non-finite loss in the timed steps")
        med = statistics.median(times)
        log(f"# pretrain step {label} B={TRAIN_BATCH} bf16: seconds {times!r}; median "
            f"{med * 1e3!r} ms, {TRAIN_BATCH / med!r} examples/s ({card})")


def _pf_checkpoint_times(tmp: str, state, card: str) -> None:
    """(h) Seconds to save (blocking, twice; non-blocking: the return and
    the write) and to restore (twice) the first run's state, and its GB."""
    mngr = CheckpointManager(os.path.join(tmp, "timing"), save_total_limit=1)
    blocking = []
    for s in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mngr.save(s, state, blocking=True)
        blocking.append(time.perf_counter() - t0)
    gb = _dir_gb(os.path.join(tmp, "timing", "2"))
    t0 = time.perf_counter()
    mngr.save(3, state, blocking=False)
    returned = time.perf_counter() - t0
    mngr.wait()
    written = time.perf_counter() - t0
    restore = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = mngr.restore_latest(state)
        torch.cuda.synchronize()
        restore.append(time.perf_counter() - t0)
    a, b = tree_flatten_with_path(back.params), tree_flatten_with_path(state.params)
    check(back.step == 3 and all(torch.equal(a[k], b[k]) for k in b),
          "restored checkpoint differs from the state saved")
    log(f"# checkpoint {gb!r} GB: blocking save seconds {blocking!r}; non-blocking save "
        f"returns in {returned!r} s, on disk after {written!r} s; restore seconds "
        f"{restore!r} ({card})")
    shutil.rmtree(os.path.join(tmp, "timing"))


def _pf_embed_stream(engine, rows, card: str, total: dict) -> None:
    """(g) ``embed_stream`` over phase 19's 512 raw rows in chunks of one
    batch: equal to ``embed`` on the preprocessed rows bit for bit (parity,
    no masking), counts from 0 just before it; ``_dispatch`` with the
    sync debug mode at "error" (no host sync); then the timings."""
    src, tgt, ev = rows
    feats = engine.preprocess(src, tgt, ev, apply_masking=False)
    want = engine.embed(feats)
    _reset_counts(SERVING_KERNELS)
    got = np.concatenate(list(engine.embed_stream(zip(src, tgt, ev), chunk_rows=PF_CHUNK,
                                                  apply_masking=False)))
    counts = _counts(SERVING_KERNELS)
    per_batch = engine.cfg.bert.num_hidden_layers * 2 - 1
    _check_counts("embed_stream", counts,
                  {n: per_batch * math.ceil(ROWS / PF_CHUNK) for n in SERVING_KERNELS})
    _add_counts(total, counts)
    check(got.shape == want.shape and bool(np.isfinite(got).all()), "embed_stream output")
    check(np.array_equal(got, want), "embed_stream differs from embed on the same rows "
          f"(max_abs_err {float(np.abs(got - want).max())!r})")
    log(f"# embed_stream ({ROWS} rows, chunks of {PF_CHUNK}) equals embed bit for bit")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = engine._dispatch(feats, engine._bucket_poolers, engine._pooler)
    except RuntimeError as e:
        raise SmokeFailure(f"_dispatch synchronised with the card: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(np.array_equal(engine._fetch(*pending), want), "_dispatch/_fetch differ from embed")
    log("# _dispatch ran under torch.cuda.set_sync_debug_mode('error'): no host sync")
    rows_l = list(zip(src, tgt, ev))
    _, t_embed = _timed(lambda: engine.embed(feats))
    _, t_seq = _timed(lambda: engine.embed(engine.preprocess(src, tgt, ev)))
    _, t_stream = _timed(lambda: list(engine.embed_stream(rows_l, chunk_rows=PF_CHUNK)))
    _rate("embed alone (parity)", ROWS, t_embed, "pairs/s", card)
    _rate("rows -> embeddings, sequential (parity)", ROWS, t_seq, "rows/s", card)
    _rate(f"rows -> embeddings, embed_stream chunks of {PF_CHUNK} (parity)", ROWS, t_stream,
          "rows/s", card)


def _pf_prot(tmp: str, emb: str, hidden: int, total: dict) -> None:
    """(e) ``run_pretraining(variant="prot")`` at phase 11's widths (the
    config it derives from 768-wide KG vectors), B=2, one final save."""
    pfeats = _prot_features(_prot_cfg(README_ENTITIES), 2 * PF_PROT_BATCH, seed=23,
                            labels=True)
    pderived = prot_pretraining_config(pfeats, hidden)
    check(pderived == _prot_cfg(pderived.kg_vocab_size),
          f"run_pretraining derives {pderived} for ProtSTonKGs, not phase 11's widths")
    MemmapFeatureStore.write(os.path.join(tmp, "prot_store"), pfeats)
    p_out = os.path.join(tmp, "prot")
    _pf_run("run_pretraining prot", os.path.join(tmp, "prot_store"), p_out,
            PROT_TRAINING_KERNELS, _prot_training_per_step(pderived),
            list(range(1, PF_SHORT_STEPS + 1)), total, variant="prot",
            kg_embedding_path=emb, batch_size=PF_PROT_BATCH, max_steps=PF_SHORT_STEPS,
            save_steps=1000)
    pck = os.path.join(p_out, "checkpoints")
    check(CheckpointManager(pck).steps() == [PF_SHORT_STEPS], "ProtSTonKGs checkpoints")
    log(f"# ProtSTonKGs checkpoint {_dir_gb(pck)!r} GB")
    shutil.rmtree(p_out)


def phase_pretrain_files(card: str) -> dict:
    """Pre-training from files at full width (phase 21): (a) the files,
    (b) ``run_pretraining`` from the memmap store twice, (c) a resume after
    the last checkpoint is deleted, (d) the HF export read back, (e) the
    TransE and ProtSTonKGs layouts, (f) dynamic masking, (g)
    ``embed_stream``, (h) timings.  Every directory is removed at the
    end.  Returns the launch counts of its counted runs, summed."""
    t_phase = time.perf_counter()
    cfg = STonKGsConfig(bert=BertConfig(), kg_vocab_size=README_ENTITIES)
    layers = cfg.bert.num_hidden_layers
    total: dict = {}
    with tempfile.TemporaryDirectory(prefix="stonkgs_pretrain_") as tmp:
        store_dir, emb, walks, vocab_file, art, rows = _pf_files(tmp, cfg)
        store = MemmapFeatureStore(store_dir)
        features = {k: store[k] for k in store.keys()}
        derived = stonkgs_pretraining_config(features, "stonkgs", cfg.bert.hidden_size,
                                             cfg.bert.vocab_size)
        check(derived == cfg, f"run_pretraining derives {derived}, expected {cfg}")
        kw = dict(kg_embedding_path=emb, vocab_file=vocab_file, batch_size=TRAIN_BATCH,
                  max_steps=PF_STEPS, save_steps=PF_SAVE)
        per_step = _training_per_step(layers)
        steps = list(range(1, PF_STEPS + 1))

        # (b) the first run, twice: the second measures the run-to-run spread
        run1, hf = os.path.join(tmp, "run1"), os.path.join(tmp, "hf")
        s1, l1, _, eps1 = _pf_run("run_pretraining (b)", store_dir, run1, TRAINING_KERNELS,
                                  per_step, steps, total, export_hf_dir=hf, **kw)
        ckpts = CheckpointManager(os.path.join(run1, "checkpoints"))
        check(ckpts.steps() == [PF_SAVE, PF_STEPS], f"checkpoints {ckpts.steps()}")
        log(f"# run_pretraining (b) checkpoints {ckpts.steps()}, "
            f"{_dir_gb(os.path.join(run1, 'checkpoints', str(PF_SAVE)))!r} GB each; "
            f"examples/s over steps 2-{PF_STEPS}: {eps1!r} ({card})")
        init = stonkgs.init_stonkgs_params(torch.Generator().manual_seed(0), cfg)
        frozen = tree_flatten_with_path(split_frozen(s1.params)[1])
        check({t.dtype for t in frozen.values()} == {BF16}, "frozen backbones not in bf16")
        lm0 = tree_flatten_with_path(params_to(init["lm_backbone"], dtype=BF16), "lm_backbone")
        check(all(torch.equal(frozen[k].cpu(), w) for k, w in lm0.items()),
              "the LM backbone changed")
        saved = torch.load(os.path.join(run1, "checkpoints", str(PF_SAVE), "tensors.pt"),
                           map_location="cpu", weights_only=True)
        check(torch.equal(saved["params/kg_backbone"], frozen["kg_backbone"].cpu()),
              "the KG table changed between steps 3 and 6")
        check(all(torch.equal(saved["params/" + k], lm0[k]) for k in lm0),
              "the checkpoint's LM backbone differs from the initial one")
        del saved
        init = tree_flatten_with_path(split_frozen(init)[0])
        run2 = os.path.join(tmp, "run2")
        s2, l2, _, _ = _pf_run("run_pretraining (b), again", store_dir, run2, TRAINING_KERNELS,
                               per_step, steps, total, **kw)
        check(torch.equal(tree_flatten_with_path(s2.params)["kg_backbone"], frozen["kg_backbone"]),
              "the KG table differs between two runs")
        late = {s: l2[s] for s in steps[PF_SAVE:]}
        spread = _pf_spread("run to run (b) vs (b) again, steps 4-6", s1, s2, late, l1, init)
        del s2
        shutil.rmtree(run2)

        # (c) resume: without checkpoint 6 the identical call resumes at 3
        shutil.rmtree(os.path.join(run1, "checkpoints", str(PF_STEPS)))
        s3, l3, _, eps3 = _pf_run("run_pretraining (c), resumed", store_dir, run1,
                                  TRAINING_KERNELS, per_step, steps[PF_SAVE:], total, **kw)
        log(f"# resumed run's examples/s over steps 5-{PF_STEPS}: {eps3!r}")
        gap, cos, equal = _pf_spread("resumed (c) vs (b), steps 4-6", s3, s1, l3,
                                     {s: l1[s] for s in l3}, init)
        by_spread = gap <= spread[0] and cos >= spread[1] and (equal or not spread[2])
        by_limit = gap <= 1e-3 and cos >= 0.9999
        log(f"# resume held to the run-to-run spread: {by_spread}; to the limits 1e-3 / "
            f"0.9999: {by_limit}")
        check(by_spread or by_limit, "the resumed run is further from (b) than either limit")
        del s3

        # (d) the exported checkpoint, read back by from_pretrained
        engine = STonKGsEngine.from_pretrained(hf, emb, walks, vocab_file=vocab_file,
                                               batch_size=BATCH, device=DEV)
        check(engine.cfg == cfg, f"exported config {engine.cfg}")
        loaded, final = tree_flatten_with_path(engine.params), tree_flatten_with_path(s1.params)
        check(loaded.keys() == final.keys(), "the export's tree differs from the run's")
        diff = [k for k in final if k != "kg_backbone"
                and not torch.equal(loaded[k], final[k].float())]
        check(not diff, f"exported parameters differ from the run's: {diff[:5]}")
        mem = dict(s1.params, lm_backbone=params_to(s1.params["lm_backbone"], dtype=F32))
        mem["kg_backbone"] = stonkgs.build_kg_table(mem["lm_backbone"], cfg.bert, art.vectors)
        feats = engine.preprocess(*rows, apply_masking=False)
        out = engine.embed(feats)
        ref = dataclasses.replace(engine, params=mem).embed(feats)
        check(bool(np.isfinite(out).all()) and np.array_equal(out, ref),
              "the exported checkpoint embeds differently from the run's parameters")
        log(f"# export read back: {len(loaded)} leaves equal to the run's, embeddings of "
            f"{ROWS} rows equal to an engine's on the run's parameters ({_dir_gb(hf)!r} GB)")
        del mem

        # (g) embed_stream on phase 19's rows, then (h) the timings
        _pf_embed_stream(engine, rows, card, total)
        del engine
        _pf_step_times(cfg, s1, features, card)
        _pf_checkpoint_times(tmp, s1, card)

        # (f) dynamic masking from the first run's parameters
        _pf_dynamic(cfg, s1.params, store, total)
        del s1
        shutil.rmtree(run1)

        # (e) the TransE layout (256 + 4) and ProtSTonKGs at phase 11's width
        tl = cfg.text_len
        tcfg = cfg.replace(entity_len=4)
        rng = np.random.default_rng(22)
        tfeats = _pretraining_features(tcfg, 2 * TRAIN_BATCH, seed=22)
        rows_t, pos = np.arange(2 * TRAIN_BATCH), rng.integers(0, 4, 2 * TRAIN_BATCH)
        # one masked triple position a row (int(0.15 * 4) = 0), labelled
        # with its own id: the derived KG vocabulary covers every label
        tfeats["ent_masked_lm_labels"][rows_t, pos] = tfeats["input_ids"][rows_t, tl + pos]
        MemmapFeatureStore.write(os.path.join(tmp, "transe_store"), tfeats)
        t_out = os.path.join(tmp, "transe")
        _pf_run("run_pretraining transe", os.path.join(tmp, "transe_store"), t_out,
                TRAINING_KERNELS, per_step, list(range(1, PF_SHORT_STEPS + 1)), total,
                variant="transe", **dict(kw, max_steps=PF_SHORT_STEPS))
        check(CheckpointManager(os.path.join(t_out, "checkpoints")).steps() == [PF_SHORT_STEPS],
              "TransE checkpoints")
        shutil.rmtree(t_out)

        _pf_prot(tmp, emb, cfg.bert.hidden_size, total)
    torch.cuda.empty_cache()
    log(f"# pretrain files phase: {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# KG embeddings: an INDRA corpus -> the graph and its tasks -> node2vec on
# the card -> serving from the trained files, the KG battery; timing at the
# production node count
# ---------------------------------------------------------------------------

# communities of KG_COMMUNITY agents: ~11,400 nodes in the largest
# component (260 gave ~16,400, whose two node2vec runs took 75 s)
KG_COMMUNITIES = 180
KG_COMMUNITY = 50
KG_INTRA = 0.95           # share of a statement's partners in its community
KG_HUBS = 4               # hub agents (INDRA's TP53s) with KG_HUB_DEGREE partners
KG_HUB_DEGREE = 300
KG_CONTEXT_RATE = 0.01    # evidences with one of the four contexts
KG_TRIPLES_PER_CLASS = 100  # the relation task's cap (the reference's: 25,000)
KG_NODES = (10_000, 20_000)  # the largest component's size, by design
KG_DIM, KG_WALK_LEN, KG_EPOCHS, KG_WINDOW, KG_NEGATIVE = 768, 127, 4, 3, 5
# link-prediction AUC (hard predictions) at full width at least
# KG_AUC_MIN, and the mean centred cosine of the graph's edges at least
# KG_COS_MARGIN above that of random pairs, each pipeline's floor set from
# the CPU rehearsal of (a)-(b) at dim 768 and 260 communities: host AUC
# 0.553, margin 0.845; device AUC 0.500, margin 0.035 (at 180
# communities: host 0.573, 0.828; device 0.553, 0.028).  The device
# pipeline's few hundred updates, each a mean over a 172-row slab, leave
# vectors so short that the regression predicts one class (chance) or
# near it, so its margin shows what it learnt.  (At dim 64 the rehearsal
# gave AUC 0.80 and 0.56.)
KG_AUC_MIN = {"host": 0.52, "device": 0.5}
KG_COS_MARGIN = {"host": 0.5, "device": 0.02}
# card against CPU on equal inputs: fp32 sums of up to a few hundred
# contributions a row in another order (atomic adds on the card)
KG_CARD_TOL = 1e-5
KG_TIMING_NODES = 500_000  # the JAX package's production node count
KG_TIMING_DEGREE = 8       # mean partners a node of the timing graph
KG_CORPUS_TOKENS = 254_000_000  # 500,000 nodes x 4 walks x 127
KG_HOST_PAIRS = 1 << 16    # the host pipeline's batch at its cap
KG_SLAB_SLOTS = 1 << 17    # the device pipeline's slab
KG_TIMED_SLABS = 200


def _kg_agent(i: int) -> dict:
    ns = ("CHEBI", "GO")[i % 2] if i % 10 == 0 else "HGNC"
    return {"name": f"G{i}", "db_refs": {ns: str(i), "TEXT": f"g{i}"}}


def _kg_statements(rng: np.random.Generator) -> list:
    """A seeded INDRA corpus with community structure (each agent the
    subject of two statements, nine in ten with a partner of its own
    community), hubs, complexes, TEXT agents, a few small components off
    the largest one, and evidence with the four contexts, XREF_BIBR
    markers, a tab and a quote."""
    n = KG_COMMUNITIES * KG_COMMUNITY
    kinds = ("Activation", "Inhibition", "Phosphorylation", "Dephosphorylation",
             "IncreaseAmount", "DecreaseAmount", "Association", "Complex")
    contexts = (("species", ("human", "mouse", "rat")),
                ("cell_line", tuple(f"line {i}" for i in range(10))),
                ("disease", tuple(f"disease {i}" for i in range(5))),
                ("location", ("nucleus", "cytoplasm", "membrane", "mitochondrion")))
    words = ("alpha", "beta", "binds", "activates", "inhibits", "cells", "in", "the",
             "protein", "signal", "kinase", "pathway")

    def evidence(k: int) -> dict:
        text = " ".join(words[j] for j in rng.integers(0, len(words), 6)) + f" {k}."
        if k % 97 == 0:
            text += " [XREF_BIBR, XREF_BIBR]"
        if k % 1001 == 0:
            text = 'a "quoted"\tword ' + text
        ev = {"text": text, "pmid": str(10_000 + k)}
        if rng.random() < 4 * KG_CONTEXT_RATE:
            key, labels = contexts[int(rng.integers(4))]
            ev["context"] = {key: {"name": labels[int(rng.integers(len(labels)))]}}
        return ev

    def statement(k: int, a: dict, b: dict) -> dict:
        kind = kinds[k % len(kinds)]
        stmt = {"type": kind, "belief": round(float(rng.random()), 4),
                "evidence": [evidence(2 * k + j) for j in range(1 + k % 2)]}
        if kind == "Complex":
            stmt["members"] = [a, b]
        elif kind in ("Phosphorylation", "Dephosphorylation"):
            stmt.update(enz=a, sub=b)
        else:
            stmt.update(subj=a, obj=b)
        return stmt

    out, k = [], 0
    for a in np.repeat(np.arange(n), 2):
        comm = a // KG_COMMUNITY
        b = (comm * KG_COMMUNITY + rng.integers(KG_COMMUNITY) if rng.random() < KG_INTRA
             else rng.integers(n))
        partner = ({"name": f"thing{k}", "db_refs": {"TEXT": f"thing{k}"}}
                   if k % 50 == 0 else _kg_agent(int(b)))
        out.append(statement(k, _kg_agent(int(a)), partner))
        k += 1
    for h in range(KG_HUBS):
        for b in rng.integers(0, n, KG_HUB_DEGREE):
            out.append(statement(k, _kg_agent(h * (n // KG_HUBS) + 7), _kg_agent(int(b))))
            k += 1
    for i in range(5):                       # small components off the largest
        out.append(statement(k, _kg_agent(n + 2 * i), _kg_agent(n + 2 * i + 1)))
        k += 1
    return out


def _kg_extract(tmp: str) -> tuple:
    """(a) The corpus through ``read_indra_triples``: the files, their
    counts against the summary, one component of the expected size."""
    rng = np.random.default_rng(22)
    t0 = time.perf_counter()
    stmts = _kg_statements(rng)
    raw = os.path.join(tmp, "statements.jsonl")
    with open(raw, "w") as f:
        f.writelines(json.dumps(s) + "\n" for s in stmts)
    t_corpus = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths = indra_extraction.read_indra_triples(raw, os.path.join(tmp, "kg"),
                                                triples_per_class=KG_TRIPLES_PER_CLASS)
    t_extract = time.perf_counter() - t0
    check(all(os.path.exists(p) for p in paths.values()), f"extraction files {paths}")
    rows = {name: tsv_io.read_columns(p, ("source", "target"))
            for name, p in paths.items()}
    with open(os.path.join(tmp, "kg", "misc", "summary.tsv"), newline="") as f:
        summary = {r["context"]: r for r in csv.DictReader(f, delimiter="\t")}
    for name in indra_extraction.TASKS:
        check(int(summary[name]["number_of_triples"]) == len(rows[name]["source"]) > 0,
              f"{name}: {len(rows[name]['source'])} rows, summary {summary[name]}")
    rel = len(rows["relation_type"]["source"])
    check(int(summary["(in)direct relations and polarity"]["number_of_triples"]) == rel
          == 4 * KG_TRIPLES_PER_CLASS, f"relation_type: {rel} rows")
    # every written triple lies in one component of the expected size
    kg = kg_graph.MultiDiGraph()
    for r in rows.values():
        for u, v in zip(r["source"], r["target"]):
            kg.add_edge(u, v)
    comps = kg.connected_components()
    with open(os.path.join(tmp, "kg", "misc", "indra_kg_overview_summary.json")) as f:
        n_kg = sum(json.load(f)[0]["value"].values())
    n_files = kg.number_of_nodes()
    check(len(comps) == 1 and KG_NODES[0] <= n_files <= n_kg <= KG_NODES[1],
          f"{len(comps)} components, {n_files} nodes in the files, {n_kg} in the KG")
    n = KG_COMMUNITIES * KG_COMMUNITY
    check(not any(f" G{n + i})" in name for name in kg.nodes() for i in range(10)),
          "a node of a small component survived")
    log(f"# kg (a) corpus: {len(stmts)} statements written in {t_corpus!r} s; extraction "
        f"{t_extract!r} s: {n_kg} nodes in the largest component, {n_files} in the files; "
        f"rows {({k: len(r['source']) for k, r in rows.items()})}")
    return paths


def _kg_cosines(result, graph) -> tuple:
    """Mean cosine of the graph's edges and of 20,000 random node pairs,
    the vectors centred first (the host pipeline's share one direction:
    their raw cosines are all near 1)."""
    row = {n: i for i, n in enumerate(result.index_to_word)}
    v = result.vectors[[row[n] for n in graph.names]].astype(np.float64)
    v -= v.mean(axis=0)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    src = np.repeat(np.arange(graph.n_nodes), np.diff(graph.indptr))
    a, b = np.random.default_rng(0).integers(0, graph.n_nodes, (2, 20_000))
    return (float((v[src] * v[graph.indices]).sum(1).mean()),
            float((v[a] * v[b]).sum(1).mean()))


def _kg_node2vec(paths: dict, tmp: str, card: str) -> dict:
    """(b) ``run_node2vec`` at the reference's settings on the card, host
    and device pipelines: files, the row-pairing quirk, finite vectors,
    the link-prediction AUC.  Returns {pipeline: (result, walks, graph,
    embeddings TSV, walks TSV)}."""
    check(walker.is_native(), "the native walker did not build")
    runs = {}
    for label, device_pipeline in (("host", False), ("device", True)):
        out = os.path.join(tmp, f"n2v_{label}")
        os.makedirs(out)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result, walks, graph = node2vec.run_node2vec(
            pretraining_path=paths["pretraining"], dimensions=KG_DIM, walk_length=KG_WALK_LEN,
            epochs=KG_EPOCHS, window_size=KG_WINDOW, negative=KG_NEGATIVE, iterations=1,
            output_dir=out, device_pipeline=device_pipeline, device=DEV)
        seconds = time.perf_counter() - t0
        emb = os.path.join(out, "embeddings_best_model.tsv")
        rw = os.path.join(out, "random_walks_best_model.tsv")
        names, rests = read_tsv(emb)
        check(names == result.index_to_word and len(names) == graph.n_nodes,
              f"{label}: embeddings rows")
        check(all(r.count("\t") == KG_DIM - 1 for r in rests[:50]), f"{label}: embedding width")
        wnames, wrests = read_tsv(rw)
        check(wnames == names and all(r.count("\t") == KG_WALK_LEN - 1 for r in wrests),
              f"{label}: walks rows")
        check(all(wrests[k].split("\t")[0] == graph.names[k] for k in range(0, len(wrests), 97)),
              f"{label}: walk row k does not start at node k (the reference's pairing)")
        check(bool(np.isfinite(result.vectors).all()) and result.vectors.shape == (
            graph.n_nodes, KG_DIM), f"{label}: vectors {result.vectors.shape}, not finite")
        t1 = time.perf_counter()
        auc = node2vec.run_link_prediction(graph, result, seed=0)
        t_lp = time.perf_counter() - t1
        edge_cos, random_cos = _kg_cosines(result, graph)
        log(f"# kg (b) run_node2vec {label} pipeline: {graph.n_nodes} nodes, walks "
            f"{walks.shape}, dim {KG_DIM}, {seconds!r} s (peak "
            f"{torch.cuda.max_memory_allocated() / 2**30!r} GiB); link prediction AUC {auc!r} "
            f"in {t_lp!r} s; mean centred cosine of edges {edge_cos!r}, of random pairs "
            f"{random_cos!r} ({card})")
        check(auc >= KG_AUC_MIN[label],
              f"{label}: link-prediction AUC {auc!r} < {KG_AUC_MIN[label]}")
        check(edge_cos - random_cos >= KG_COS_MARGIN[label],
              f"{label}: edges' cosine {edge_cos!r} not {KG_COS_MARGIN[label]} above random "
              f"pairs' {random_cos!r}")
        runs[label] = (result, walks, graph, emb, rw)
    return runs


def _kg_card_vs_cpu(result, walks, graph) -> float:
    """(c) One host-pipeline step and one device slab on the card against
    the CPU on equal inputs (the slab's draws made on the card, copied to
    the CPU); the slab's keep, window and negative rates, and its mask
    density beside ``_make_pairs`` on the same rows.  Returns the largest
    error."""
    counts, order, rank = word2vec._build_vocab(walks, graph.n_nodes)
    ranked = rank[walks].astype(np.int32)
    counts_sorted = counts[order]
    keep_prob = word2vec._keep_probabilities(counts_sorted, 1e-3)
    neg_probs = word2vec._negative_probabilities(counts_sorted)
    V = graph.n_nodes
    gen = torch.Generator().manual_seed(23)
    syn = [torch.randn(V, KG_DIM, generator=gen) * 0.1 for _ in range(2)]
    rng = np.random.default_rng(23)
    c, x = word2vec._make_pairs(ranked[:2_000], KG_WINDOW, rng, keep_prob)
    pick = rng.permutation(len(c))[:KG_HOST_PAIRS]
    neg = np.searchsorted(np.cumsum(neg_probs), rng.random((KG_HOST_PAIRS, KG_NEGATIVE)))
    batch = [torch.from_numpy(a.astype(np.int32)) for a in (c[pick], x[pick], neg)]
    errs = {}
    cpu = word2vec._sgd_core(*(t.clone() for t in syn), *batch, 0.025)
    dev = word2vec._sgd_core(*(t.to(DEV, copy=True) for t in syn), *(b.to(DEV) for b in batch),
                             0.025)
    errs["host step"] = max(float((a.cpu() - b).abs().max()) for a, b in zip(dev, cpu))
    moved = max(float((a - b).abs().max()) for a, b in zip(cpu, syn))

    # the device slab: draws on the card, the computation on both
    slab_rows = KG_SLAB_SLOTS // word2vec._pair_slots_per_row(KG_WALK_LEN, KG_WINDOW)
    toks = torch.from_numpy(ranked[rng.permutation(len(ranked))[:slab_rows]])
    keep_t = torch.from_numpy(keep_prob)
    alias, thresh = (torch.from_numpy(a) for a in word2vec._build_alias(neg_probs))
    g = torch.Generator(device=DEV).manual_seed(word2vec._slab_seed(0, 0, 0))
    keep, red = word2vec._slab_draws(toks.to(DEV), keep_t.to(DEV), KG_WINDOW, g)
    cell, u = word2vec._negative_draws(2 * KG_WINDOW * toks.numel(), KG_NEGATIVE, V, g, DEV)
    draws = [t.cpu() for t in (keep, red, cell, u)]
    valid = torch.ones(slab_rows, dtype=torch.bool)

    def slab(tables, on):
        keep_, red_, cell_, u_, toks_, valid_, alias_, thresh_ = (
            a.to(on) for a in (*draws, toks, valid, alias, thresh))
        cen, ctx, mask = word2vec._device_pair_slab(toks_, valid_, keep_, red_, KG_WINDOW)
        negs = word2vec._alias_negatives(cell_, u_, alias_, thresh_)
        word2vec._sgd_core(*tables, cen, ctx, negs, 0.025, mask)
        return tables, mask

    (cpu, mask), (dev, _) = slab([a.clone() for a in syn], "cpu"), slab(
        [a.to(DEV, copy=True) for a in syn], DEV)
    errs["device slab"] = max(float((a.cpu() - b).abs().max()) for a, b in zip(dev, cpu))
    log(f"# kg (c) card vs CPU, equal inputs: host step of {KG_HOST_PAIRS} pairs and a device "
        f"slab of {slab_rows} rows ({mask.numel()} slots): max_abs_err {errs} (the tables "
        f"moved by up to {moved!r})")
    for name, err in errs.items():
        check(err <= KG_CARD_TOL, f"kg {name}: card vs CPU {err!r} > {KG_CARD_TOL}")

    # the draws' rates, each within 4 sigma
    p_keep = keep_prob[toks.numpy()].astype(np.float64)
    sigma = math.sqrt((p_keep * (1 - p_keep)).sum()) / p_keep.size
    kept = float(draws[0].double().mean())
    red_freq = np.bincount(draws[1].numpy().ravel(), minlength=KG_WINDOW) / draws[1].numel()
    negs = word2vec._alias_negatives(*draws[2:], alias, thresh).numpy().ravel()
    top = np.argsort(-neg_probs)[:20]
    neg_freq = np.bincount(negs, minlength=V)[top] / negs.size
    neg_sigma = np.sqrt(neg_probs[top] * (1 - neg_probs[top]) / negs.size)
    red_sigma = math.sqrt((1 / KG_WINDOW) * (1 - 1 / KG_WINDOW) / draws[1].numel())
    pc, _ = word2vec._make_pairs(toks.numpy(), KG_WINDOW, np.random.default_rng(5), keep_prob)
    density, want_density = float(mask.mean()), len(pc) / mask.numel()
    neg_dev = float(np.abs(neg_freq - neg_probs[top]).max() / neg_sigma.max())
    log(f"# kg (c) slab draws: keep {kept!r} (expected {p_keep.mean()!r}, min keep "
        f"probability {float(keep_prob.min())!r}); reduced windows {red_freq.tolist()}; the 20 "
        f"likeliest negatives' frequencies within {neg_dev!r} sigma; mask density "
        f"{density!r} against {want_density!r} from _make_pairs")
    check(abs(kept - p_keep.mean()) <= 4 * sigma + 1e-12, "kg slab keep rate")
    check(float(keep_prob.min()) < 1.0, "kg: no token was subsampled (no hub in the corpus)")
    check(bool((np.abs(red_freq - 1 / KG_WINDOW) <= 4 * red_sigma).all()), "kg reduced windows")
    check(bool((np.abs(neg_freq - neg_probs[top]) <= 4 * neg_sigma).all()), "kg negatives")
    check(abs(density - want_density) <= 0.03 * want_density, "kg slab mask density")
    return max(errs.values())


def _no_duplicates_tasks(paths: dict, root: str) -> int:
    """The extracted tasks after ``filter_out_duplicates``, where the
    battery reads them; returns the rows written."""
    import pandas as pd

    n = 0
    for name in indra_extraction.TASKS + ("relation_type",):
        df = filters.filter_out_duplicates(pd.read_csv(paths[name], sep="\t"), name)
        os.makedirs(os.path.join(root, name))
        df.to_csv(os.path.join(root, name, f"{name}_no_duplicates.tsv"), sep="\t", index=False)
        n += len(df)
    return n


def _kg_serving(paths: dict, run: tuple, tmp: str, card: str) -> dict:
    """(d) ``save_pretrained`` (BERT-base, the new graph's KG vocabulary),
    then ``from_pretrained`` on the trained TSVs -> ``preprocess`` on rows
    of the extracted pre-training TSV -> ``embed``, counted from 0; then
    the KG battery over the extracted tasks.  Returns the launch counts."""
    result, _, graph, emb, rw = run
    cfg = STonKGsConfig(bert=BertConfig(), kg_vocab_size=graph.n_nodes)
    t0 = time.perf_counter()
    params = stonkgs.init_stonkgs_params(torch.Generator().manual_seed(22), cfg)
    ckpt = save_pretrained(params, cfg, os.path.join(tmp, "ckpt"))
    del params
    vocab_file = os.path.join(tmp, "vocab.txt")
    with open(vocab_file, "w") as f:
        f.write("\n".join(_readme_vocab(cfg.bert.vocab_size, np.random.default_rng(22))) + "\n")
    engine = STonKGsEngine.from_pretrained(ckpt, emb, rw, vocab_file=vocab_file,
                                           batch_size=BATCH, device=DEV)
    check(engine.cfg == cfg and engine.artifacts.n_entities == graph.n_nodes,
          f"kg engine config {engine.cfg}")
    pre = tsv_io.read_columns(paths["pretraining"], ("source", "target", "evidence"))
    feats = engine.preprocess(*(pre[c][:ROWS] for c in ("source", "target", "evidence")))
    t_setup = time.perf_counter() - t0
    _reset_counts(SERVING_KERNELS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = engine.embed(feats)
    first = time.perf_counter() - t1
    counts = _counts(SERVING_KERNELS)
    n_batches, per_batch = math.ceil(ROWS / BATCH), cfg.bert.num_hidden_layers * 2 - 1
    log(f"# kg (d) checkpoint, from_pretrained and preprocess in {t_setup!r} s; embed of "
        f"{ROWS} extracted rows: launches {counts}")
    check(out.shape == (ROWS, cfg.bert.hidden_size) and bool(np.isfinite(out).all()),
          f"kg embed output {out.shape}, not finite")
    for name, c in counts.items():
        check(c == per_batch * n_batches, f"kg embed {name}: {c} launches, expected "
              f"{per_batch} x {n_batches}")
    del engine
    torch.cuda.empty_cache()

    root = os.path.join(tmp, "battery")
    n_rows = _no_duplicates_tasks(paths, root)
    t0 = time.perf_counter()
    results = batteries.run_all_kg_baseline_tasks(root, load_kg_artifacts(emb, rw), cv=2,
                                                  epochs=1, device=DEV)
    log(f"# kg (d) KG battery over {n_rows} extracted rows (no duplicates), cv 2, 1 epoch, in "
        f"{time.perf_counter() - t0!r} s: {results} ({card})")
    check(sorted(results) == sorted(["cell_line", "disease", "location", "species",
                                     "interaction", "polarity"]), f"battery tasks {results}")
    check(all(0.0 <= r["f1_score_mean"] <= 1.0 for r in results.values()), "battery F1")
    return counts


def _kg_timing(card: str) -> None:
    """(e) At the production node count: the walker's steps/s, the host
    pipeline's pair generation and step, the device pipeline's slab, its
    busy share under the profiler, peak memory, and projections for the
    254 M-token corpus."""
    n, rng = KG_TIMING_NODES, np.random.default_rng(24)
    t0 = time.perf_counter()
    a = np.repeat(np.arange(n), KG_TIMING_DEGREE // 2)
    comm = a // KG_COMMUNITY
    b = np.where(rng.random(a.size) < KG_INTRA, comm * KG_COMMUNITY
                 + rng.integers(0, KG_COMMUNITY, a.size), rng.integers(0, n, a.size))
    rows, cols = np.concatenate([a, b]), np.concatenate([b, a])
    order = np.lexsort((cols, rows))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))]).astype(np.int64)
    graph = CSRGraph([str(i) for i in range(n)], indptr, cols[order].astype(np.int32))
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    walks = walker.random_walks(graph, walk_len=KG_WALK_LEN, epochs=1, seed=0)
    t_walk = time.perf_counter() - t0
    steps = walks.shape[0] * (KG_WALK_LEN - 1)
    log(f"# kg (e) graph: {n} nodes, {len(graph.indices)} directed edges, built in {t_graph!r} s;"
        f" walker: {steps} steps in {t_walk!r} s = {steps / t_walk!r} steps/s on "
        f"{os.cpu_count()} CPUs")

    counts, order, rank = word2vec._build_vocab(walks, n)
    ranked = rank[walks].astype(np.int32)
    counts_sorted = counts[order]
    keep_prob = word2vec._keep_probabilities(counts_sorted, 1e-3)
    neg_probs = word2vec._negative_probabilities(counts_sorted)
    # host pair generation on a slice of rows, then the host loop's step
    t0 = time.perf_counter()
    c, x = word2vec._make_pairs(ranked[:50_000], KG_WINDOW, rng, keep_prob)
    perm = rng.permutation(len(c))
    c, x = c[perm], x[perm]
    t_pairs = time.perf_counter() - t0
    pairs_per_s = len(c) / t_pairs
    pairs_per_token = len(c) / (50_000 * KG_WALK_LEN)
    torch.cuda.reset_peak_memory_stats()
    syn0 = word2vec._init_syn0(n, KG_DIM, 0, DEV)
    syn1 = torch.zeros_like(syn0)
    neg_cum = np.cumsum(neg_probs)
    seconds, draw_s = [], []
    with torch.no_grad():
        for i in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            negs = np.searchsorted(neg_cum, rng.random((KG_HOST_PAIRS, KG_NEGATIVE)))
            draw_s.append(time.perf_counter() - t0)
            batch = np.empty((KG_HOST_PAIRS, 2 + KG_NEGATIVE), np.int32)
            sl = slice(i * KG_HOST_PAIRS, (i + 1) * KG_HOST_PAIRS)
            batch[:, 0], batch[:, 1], batch[:, 2:] = c[sl], x[sl], negs
            dev = host_to_device(batch, DEV)
            word2vec._sgd_core(syn0, syn1, dev[:, 0], dev[:, 1], dev[:, 2:], 0.025)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        dev = host_to_device(batch, DEV)
        step_ms = time_ms(lambda: word2vec._sgd_core(syn0, syn1, dev[:, 0], dev[:, 1],
                                                     dev[:, 2:], 0.025), iters=10)
    host_step_ms = statistics.median(seconds[2:]) * 1e3
    host_minutes = (KG_CORPUS_TOKENS * pairs_per_token / KG_HOST_PAIRS * host_step_ms / 1e3
                    + KG_CORPUS_TOKENS * pairs_per_token / pairs_per_s) / 60
    log(f"# kg (e) host pipeline: pairs {pairs_per_s!r} pairs/s on the host ({pairs_per_token!r}"
        f" a token); a step of {KG_HOST_PAIRS} pairs {host_step_ms!r} ms with its host work "
        f"(median of 10; the negatives' draws and searchsorted over the {n}-entry CDF "
        f"{statistics.median(draw_s[2:]) * 1e3!r} ms of it), {step_ms!r} ms on the card "
        f"alone; projected {host_minutes!r} min for {KG_CORPUS_TOKENS} tokens (pairs + "
        f"steps, 1 iteration; {card})")

    # the device pipeline's slab at 2^17 slots
    slab_rows = KG_SLAB_SLOTS // word2vec._pair_slots_per_row(KG_WALK_LEN, KG_WINDOW)
    corpus = host_to_device(ranked, DEV)
    perm = host_to_device(rng.permutation(len(ranked)).astype(np.int32), DEV)
    keep = host_to_device(keep_prob, DEV)
    alias, thresh = (host_to_device(t, DEV) for t in word2vec._build_alias(neg_probs))
    gen = torch.Generator(device=DEV)

    def slabs(first: int, count: int) -> None:
        for s in range(first, first + count):
            gen.manual_seed(word2vec._slab_seed(0, 0, s))
            word2vec._sgns_slab(syn0, syn1, corpus, perm, len(ranked), s, slab_rows, gen, keep,
                                alias, thresh, 0.025, window=KG_WINDOW, negative=KG_NEGATIVE)

    with torch.no_grad():
        slabs(0, 3)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        slabs(3, KG_TIMED_SLABS)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        slab_ms = start.elapsed_time(end) / KG_TIMED_SLABS
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            slabs(3 + KG_TIMED_SLABS, KG_TIMED_SLABS)
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    busy = (f"{device_ms / (wall_prof * 1e3)!r} ({device_ms / KG_TIMED_SLABS!r} ms of kernels a "
            f"slab under the profiler)" if device_ms > 0 else "not measured (no device time)")
    launches = sum(e.count for e in kernels) / KG_TIMED_SLABS
    tokens_per_s = slab_rows * KG_WALK_LEN / (slab_ms / 1e3)
    host_ms = wall * 1e3 / KG_TIMED_SLABS
    log(f"# kg (e) device pipeline: a slab of {slab_rows} rows ({KG_SLAB_SLOTS} slots) "
        f"{slab_ms!r} ms on the card ({KG_TIMED_SLABS} slabs, host clock {host_ms!r}"
        f" ms a slab) = {tokens_per_s!r} tokens/s; {launches!r} kernels a slab; device busy "
        f"{busy}; projected {KG_CORPUS_TOKENS / tokens_per_s / 60!r} min for "
        f"{KG_CORPUS_TOKENS} tokens; peak memory {torch.cuda.max_memory_allocated() / 2**30!r} "
        f"GiB ({card})")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log("# kg (e) slab kernels: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3 / KG_TIMED_SLABS!r} ms "
        f"x{e.count / KG_TIMED_SLABS!r}" for e in top))
    check(bool(torch.isfinite(syn0).all()) and bool(torch.isfinite(syn1).all()),
          "kg timing tables not finite")


def phase_kg_embeddings(card: str) -> dict:
    """KG embeddings (phase 22): (a) extraction, (b) node2vec at full width
    with both pipelines, (c) card against CPU, (d) serving from the
    trained files and the KG battery, (e) timing at the production node
    count.  Returns (d)'s embed launch counts."""
    t_phase = time.perf_counter()

    def done(part: str) -> None:
        log(f"# kg {part}: {time.perf_counter() - t_phase:.1f} s")

    with tempfile.TemporaryDirectory(prefix="stonkgs_kg_") as tmp:
        paths = _kg_extract(tmp)
        done("(a)")
        runs = _kg_node2vec(paths, tmp, card)
        done("(a)-(b)")
        result, walks, graph, _, _ = runs["host"]
        _kg_card_vs_cpu(result, walks, graph)
        done("(a)-(c)")
        counts = _kg_serving(paths, runs["host"], tmp, card)
        done("(a)-(d)")
        del runs, result, walks
    torch.cuda.empty_cache()
    _kg_timing(card)
    torch.cuda.empty_cache()
    log(f"# kg embeddings phase: {time.perf_counter() - t_phase:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 23: parallelism on torch.distributed (a world of one on NCCL, two
# ranks on cuda:0 over gloo)
# ---------------------------------------------------------------------------

PAR_STEPS = 4            # steps of every STonKGs run of the phase
PAR_SHORT_STEPS = 2      # the ProtSTonKGs and fine-tuning runs
PAR_FT_ROWS = 16         # fine-tuning rows: 2 steps of B=8
PAR_STORE_ROWS = TRAIN_BATCH * PAR_STEPS
# a rank's run against one rank's: passes within PAR_SPREADS times the
# spread of two one-rank runs that differ as the mesh does (the batch summed
# in two halves; for ProtSTonKGs two runs of one code, whose BigBird
# backward adds with atomics), or within these limits
PAR_SPREADS = 4
PAR_LOSS_GAP = 1e-2      # largest relative gap of a step's loss
PAR_UPDATE_COS = 0.999   # cosine of the whole trainable update (final - initial)
PAR_LEAF_COS = 0.95      # lowest cosine of one trainable leaf's update: in bf16 a small
                         # leaf's update moves with the rounding of a split reduction
PAR_NU_GAP = 5e-2        # relative gap of the summed second moment (the gradients' scale)
# ProtSTonKGs on 1 x 2 in fp32 at 2 layers a stack against one rank: the
# lowest cosine of the whole update (the mesh draws the unmeshed run's
# dropout masks, so only summation order parts them)
PAR_FP32_UPDATE_COS = 0.99999
PAR_PROT_FP32_LAYERS = 2
PAR_PROT_PAIRS = 3       # one-rank runs held to the first: the bf16 gate's spread samples
# (label, n_data, n_model, fsdp, dropout): the 2 x 1 shards draw other
# dropout masks than one rank, so there dropout is 0
PAR_MESHES = (("1x2 TP", 1, 2, False, True), ("2x1 FSDP", 2, 1, True, False),
              ("2x1 DP", 2, 1, False, False))


def _par_cfg(dropout: bool) -> STonKGsConfig:
    cfg = STonKGsConfig(bert=BertConfig(), kg_vocab_size=100_000)
    if dropout:
        return cfg
    return cfg.replace(bert=dataclasses.replace(cfg.bert, hidden_dropout_prob=0.0,
                                                attention_probs_dropout_prob=0.0))


def _par_pretrain(cfg, params, feats, steps: int, batch: int, *, mesh=None, fsdp=False,
                  accum: int = 1, loss_fn=None, kernels=TRAINING_KERNELS,
                  compute_dtype: str = "bfloat16") -> dict:
    """``pretrain`` with the counts from 0 just before it; returns the
    state, losses, seconds a step after the first (from the last logged
    examples/s, which ``pretrain`` takes between synchronised ends), counts
    and the peak memory above the start (GB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run = pretraining.PretrainingConfig(max_steps=steps, micro_batch_size=batch // accum,
                                        grad_accumulation_steps=accum, log_steps=1,
                                        compute_dtype=compute_dtype, fsdp=fsdp)
    logged = []
    _reset_counts(kernels)
    state = pretraining.pretrain(cfg, params, feats, run, mesh=mesh, loss_fn=loss_fn,
                                 log_fn=lambda s, m: logged.append(m))
    torch.cuda.synchronize()
    eps = logged[-1].get("examples_per_sec")
    return {"state": state, "losses": [m["loss"] for m in logged], "counts": _counts(kernels),
            "step_s": batch / eps if eps else None,
            "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}


def _state_gb(state) -> float:
    """GB of the parameters and moments a rank holds."""
    leaves = (tree_leaves(state.params) + tree_leaves(state.opt_state["mu"])
              + tree_leaves(state.opt_state["nu"]))
    return sum(t.numel() * t.element_size() for t in leaves) / 1e9


def _whole(state) -> tuple:
    """(trainable params, nu) of a state, gathered whole where it holds slices."""
    train, nu = split_frozen(state.params)[0], state.opt_state["nu"]
    if state.layout is not None:
        train, nu = state.layout.gather(train), state.layout.gather(nu)
    return tree_flatten_with_path(train), tree_flatten_with_path(nu)


def _nu_sum(nu: dict) -> float:
    return float(sum(t.double().sum() for t in nu.values()))


def _par_reference(run: dict, path: str) -> dict:
    """A one-rank run's losses, final trainable leaves and summed second
    moment, saved for the ranks to compare with (CPU tensors)."""
    train, nu = _whole(run["state"])
    ref = {"losses": run["losses"], "nu_sum": _nu_sum(nu),
           "train": {k: t.cpu() for k, t in train.items()}}
    torch.save(ref, path)
    return ref


def _par_gap(label: str, losses: list, train: dict, nu_sum: float, ref: dict,
             init: dict, unused=UNUSED_LEAVES) -> tuple:
    """(largest relative loss gap, cosine of the whole update, lowest leaf
    update cosine, nu gap) of a run against a one-rank reference; leaves
    without a gradient (held equal) and the key biases (zero gradient in
    exact arithmetic) left out of the cosines."""
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    cosines, dot, na, nb = {}, 0.0, 0.0, 0.0
    for k, w in ref["train"].items():
        got = train[k].to(DEV)
        if k.startswith(unused):
            check(torch.equal(got.cpu(), w), f"{label}: unused leaf {k} changed")
            continue
        if any(z in k for z in ZERO_GRAD_LEAVES):
            continue
        ua, ub = (got - init[k].to(DEV)).flatten(), (w.to(DEV) - init[k].to(DEV)).flatten()
        if torch.equal(ua, ub):
            continue
        ua, ub = ua.double(), ub.double()
        c = float(F.cosine_similarity(ua, ub, dim=0))
        cosines[k] = c if math.isfinite(c) else -1.0
        dot, na, nb = dot + float(ua @ ub), na + float(ua @ ua), nb + float(ub @ ub)
    nu_gap = abs(nu_sum / ref["nu_sum"] - 1.0)
    worst = sorted(cosines, key=cosines.get)[:3]
    log(f"# {label}: lowest leaf update cosines "
        f"{[(k, cosines[k], ref['train'][k].numel()) for k in worst]!r}")
    whole = dot / math.sqrt(na * nb) if na and nb else 1.0
    return gap, whole, min(cosines.values(), default=1.0), nu_gap


def _replica_print(state) -> list:
    """A bit-exact fingerprint of the leaves and moments a rank holds whole
    (replicated): every rank of the mesh must print the same."""
    words = []
    for tree in (split_frozen(state.params)[0], state.opt_state["mu"], state.opt_state["nu"]):
        for p, t in tree_flatten_with_path(tree).items():
            if state.layout.kind(p) == "replicated":
                words.append(t.reshape(-1).view(torch.int32).to(torch.int64))
    flat = torch.cat(words)
    weight = torch.arange(flat.numel(), device=flat.device) % 1_000_003 + 1
    return [int(flat.sum()), int((flat * weight).sum()), int(flat.numel())]


def _par_rank(job: dict) -> dict:
    """One of two ranks on cuda:0 (gloo): (b) the three meshes, (c)
    ProtSTonKGs on 1 x 2, (d) ``train_classifier`` on 2 x 1, (e)
    ``run_pretraining(n_model_shards=2)`` with a save and a resume.  Rank 0
    compares the gathered results with the one-rank references."""
    import torch.distributed as dist
    from stonkgs_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    out = {"rank": rank, "device": str(torch.cuda.current_device())}
    params = torch.load(job["params"], weights_only=True)
    init = tree_flatten_with_path(split_frozen(params)[0])
    feats = {k: np.load(os.path.join(job["feats"], k + ".npy")) for k in job["feat_keys"]}
    refs = {}
    for label, n_data, n_model, fsdp, dropout in PAR_MESHES:
        mesh = make_mesh(n_data, n_model)
        run = _par_pretrain(_par_cfg(dropout), params_to(params, DEV), feats, PAR_STEPS,
                            TRAIN_BATCH, mesh=mesh, fsdp=fsdp)
        state = run.pop("state")
        res = {**run, "state_gb": _state_gb(state), "print": _replica_print(state)}
        train, nu = _whole(state)
        if rank == 0:
            ref_path = job["ref_on"] if dropout else job["ref_off"]
            refs.setdefault(ref_path, torch.load(ref_path, weights_only=True))
            res["gap"] = _par_gap(label, run["losses"], train, _nu_sum(nu), refs[ref_path], init)
        out[label] = res
        del state, train, nu
        torch.cuda.empty_cache()
    del refs

    # (c) ProtSTonKGs on 1 x 2
    pcfg = _prot_cfg()
    pparams = torch.load(job["pparams"], weights_only=True)
    pinit = tree_flatten_with_path(split_frozen(pparams)[0])
    pfeats = _prot_features(pcfg, PROT_TRAIN_BATCH * PAR_SHORT_STEPS, seed=23, labels=True)
    loss_fn = functools.partial(protstonkgs.pretraining_loss, rand_attn=_train_plan(pcfg))
    run = _par_pretrain(pcfg, params_to(pparams, DEV), pfeats, PAR_SHORT_STEPS,
                        PROT_TRAIN_BATCH, mesh=make_mesh(1, 2), loss_fn=loss_fn,
                        kernels=PROT_TRAINING_KERNELS)
    state = run.pop("state")
    res = {**run, "state_gb": _state_gb(state), "print": _replica_print(state)}
    train, nu = _whole(state)
    if rank == 0:
        res["gap"] = _par_gap("ProtSTonKGs 1x2", run["losses"], train, _nu_sum(nu),
                              torch.load(job["ref_prot"], weights_only=True), pinit,
                              PROT_UNUSED_LEAVES)
    out["prot 1x2"] = res
    del state, train, nu, pparams
    torch.cuda.empty_cache()
    # ... and in fp32 at 2 layers a stack
    pcfg32 = _prot_cfg(layers=PAR_PROT_FP32_LAYERS)
    p32 = torch.load(job["pparams32"], weights_only=True)
    run = _par_pretrain(pcfg32, params_to(p32, DEV), pfeats, PAR_SHORT_STEPS, PROT_TRAIN_BATCH,
                        mesh=make_mesh(1, 2), loss_fn=functools.partial(
                            protstonkgs.pretraining_loss, rand_attn=_train_plan(pcfg32)),
                        kernels=PROT_TRAINING_KERNELS, compute_dtype="float32")
    state = run.pop("state")
    res = {**run, "print": _replica_print(state)}
    train, nu = _whole(state)   # a gather: every rank takes part
    if rank == 0:
        res["gap"] = _par_gap("ProtSTonKGs 1x2 fp32", run["losses"], train, _nu_sum(nu),
                              torch.load(job["ref_prot32"], weights_only=True),
                              tree_flatten_with_path(split_frozen(p32)[0]), PROT_UNUSED_LEAVES)
    out["prot 1x2 fp32"] = res
    del state, train, nu, p32
    torch.cuda.empty_cache()

    # (d) train_classifier on 2 x 1
    ccfg = _par_cfg(False).replace(num_labels=2)
    cfeats = _par_ft_features(ccfg)
    _reset_counts(TRAINING_KERNELS)
    cstate, metrics = finetuning.train_classifier(
        ccfg, params_to(params, DEV), cfeats, _par_ft_run(), mesh=make_mesh(2, 1), rng_seed=3)
    torch.cuda.synchronize()
    train, nu = _whole(cstate)
    res = {"counts": _counts(TRAINING_KERNELS), "metrics": metrics,
           "print": _replica_print(cstate), "step": cstate.step}
    if rank == 0:
        ref = torch.load(job["ref_ft"], weights_only=True)
        cinit = {**init, **{k: v for k, v in ref["head0"].items()}}
        res["gap"] = _par_gap("train_classifier 2x1", [metrics["loss"]], train, _nu_sum(nu),
                              ref, cinit)
    out["classifier 2x1"] = res
    del cstate, train, nu
    torch.cuda.empty_cache()

    # (e) run_pretraining(n_model_shards=2) from the store, saved at 2, resumed
    kw = dict(batch_size=TRAIN_BATCH, max_steps=PAR_STEPS, save_steps=2, log_steps=1,
              device=DEV, n_model_shards=2, output_dir=job["run_dir"])
    _reset_counts(TRAINING_KERNELS)
    whole = run_pretraining(job["store"], **kw)
    counts = _counts(TRAINING_KERNELS)
    first = _whole(whole)[0]
    del whole
    if rank == 0:
        shutil.rmtree(os.path.join(job["run_dir"], "checkpoints", str(PAR_STEPS)))
    dist.barrier()
    _reset_counts(TRAINING_KERNELS)
    resumed = run_pretraining(job["store"], **kw)
    again = _whole(resumed)[0]
    res = {"counts": counts, "resumed_counts": _counts(TRAINING_KERNELS),
           "mesh": (resumed.layout.mesh.n_data, resumed.layout.mesh.n_model),
           "step": resumed.step, "print": _replica_print(resumed),
           "equal": all(torch.equal(first[k], again[k]) for k in first),
           "max_diff": max(float((first[k].float() - again[k].float()).abs().max())
                           for k in first)}
    out["run_pretraining 1x2"] = res
    return out


def _par_ft_features(cfg: STonKGsConfig) -> dict:
    labels = np.random.default_rng(24).integers(0, 2, PAR_FT_ROWS)
    return {**_features(cfg, PAR_FT_ROWS, seed=24), "labels": labels}


def _par_ft_run():
    return finetuning.FinetuneConfig(epochs=1, batch_size=FT_BATCH, compute_dtype="bfloat16")


def _par_verdict(label: str, gap: tuple, spread: tuple) -> None:
    """Hold a mesh run to one rank: within ``PAR_SPREADS`` spreads (each
    metric's distance from a perfect match), or within the limits."""
    k = PAR_SPREADS
    by_spread = (gap[0] <= k * spread[0] and 1 - gap[1] <= k * (1 - spread[1])
                 and 1 - gap[2] <= k * (1 - spread[2]) and gap[3] <= k * spread[3])
    by_limit = (gap[0] <= PAR_LOSS_GAP and gap[1] >= PAR_UPDATE_COS and gap[2] >= PAR_LEAF_COS
                and gap[3] <= PAR_NU_GAP)
    log(f"# {label} vs one rank: largest relative loss gap {gap[0]!r}, update cosine "
        f"{gap[1]!r} (lowest leaf {gap[2]!r}), summed second moment gap {gap[3]!r}; spread "
        f"{spread!r}; within {k} spreads: {by_spread}; within the limits {PAR_LOSS_GAP} / "
        f"{PAR_UPDATE_COS} / {PAR_LEAF_COS} / {PAR_NU_GAP}: {by_limit}")
    check(by_spread or by_limit, f"{label}: further from one rank than the spread and the limits")


def phase_parallel(card: str, params: Optional[dict] = None,
                   pparams: Optional[dict] = None) -> dict:
    """Phase 23: the mesh paths of ``pretrain``, ``train_classifier`` and
    ``run_pretraining`` at full width.  ``params`` and ``pparams`` are
    phase 5's and phase 11's CPU parameters (made here when not given).
    Returns the main paths' launch counts (this process's and rank 0's)."""
    import torch.distributed as dist
    from stonkgs_tpu_torch.parallel import multihost
    from stonkgs_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    cfg = _par_cfg(True)
    pcfg = _prot_cfg()
    if params is None:
        params = _stonkgs_params(cfg)
    if pparams is None:
        pparams = _prot_params(pcfg, seed=10, dtype=BF16)
    feats = _pretraining_features(cfg, TRAIN_BATCH * PAR_STEPS, seed=23)
    per_step = _training_per_step(cfg.bert.num_hidden_layers)
    total = {}
    init = tree_flatten_with_path(split_frozen(params)[0])

    # (a) a world of one on NCCL: the mesh path equals the unmeshed run bit for bit
    one = _par_pretrain(cfg, params_to(params, DEV), feats, PAR_STEPS, TRAIN_BATCH)
    _check_counts(f"pretrain, one rank ({PAR_STEPS} steps)", one["counts"],
                  {n: c * PAR_STEPS for n, c in per_step.items()})
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{multihost.free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1)
        meshed = _par_pretrain(cfg, params_to(params, DEV), feats, PAR_STEPS, TRAIN_BATCH,
                               mesh=mesh)
    finally:
        dist.destroy_process_group()
    _check_counts(f"pretrain, 1x1 mesh on NCCL ({PAR_STEPS} steps)", meshed["counts"],
                  {n: c * PAR_STEPS for n, c in per_step.items()})
    _add_counts(total, meshed["counts"])
    a = tree_flatten_with_path(one["state"].params)
    b = tree_flatten_with_path(meshed["state"].params)
    unequal = [k for k in a if not torch.equal(a[k], b[k])]
    log(f"# (a) 1x1 mesh on NCCL vs unmeshed: losses {meshed['losses']!r} vs {one['losses']!r}; "
        f"{len(unequal)} of {len(a)} leaves differ; peak above the start "
        f"{meshed['peak_gb']!r} GB, state {_state_gb(meshed['state'])!r} GB a rank ({card})")
    check(meshed["losses"] == one["losses"], "(a) the 1x1 mesh's losses differ from one rank's")
    check(not unequal, f"(a) the 1x1 mesh's parameters differ: {unequal[:5]}")
    log(f"# (a) seconds a step after the first: unmeshed {one['step_s']!r}, 1x1 mesh on NCCL "
        f"{meshed['step_s']!r} ({card})")
    meshed.pop("state")
    del a, b

    with tempfile.TemporaryDirectory(prefix="stonkgs_parallel_") as tmp:
        # the one-rank references, and the spread of a one-rank run whose
        # batch is summed in two halves (accumulation 2), as the 2 x 1 mesh sums it
        t0 = time.perf_counter()
        _par_reference(one, os.path.join(tmp, "ref_on.pt"))
        del one
        off = _par_pretrain(_par_cfg(False), params_to(params, DEV), feats, PAR_STEPS,
                            TRAIN_BATCH)
        ref_off = _par_reference(off, os.path.join(tmp, "ref_off.pt"))
        del off
        halves = _par_pretrain(_par_cfg(False), params_to(params, DEV), feats, PAR_STEPS,
                               TRAIN_BATCH, accum=2)
        train, nu = _whole(halves.pop("state"))
        spread = _par_gap("one rank, accumulation 2", halves["losses"], train, _nu_sum(nu),
                          ref_off, init)
        del halves, train, nu
        pfeats = _prot_features(pcfg, PROT_TRAIN_BATCH * PAR_SHORT_STEPS, seed=23, labels=True)
        loss_fn = functools.partial(protstonkgs.pretraining_loss, rand_attn=_train_plan(pcfg))
        pinit = tree_flatten_with_path(split_frozen(pparams)[0])
        # the bf16 one-rank reference and PAR_PROT_PAIRS more runs of the same
        # code held to it (the BigBird backward adds with atomics): the
        # spread is the widest of the pairs in each metric
        run = _par_pretrain(pcfg, params_to(pparams, DEV), pfeats, PAR_SHORT_STEPS,
                            PROT_TRAIN_BATCH, loss_fn=loss_fn, kernels=PROT_TRAINING_KERNELS)
        ref_prot = _par_reference(run, os.path.join(tmp, "ref_prot.pt"))
        del run
        pairs = []
        for i in range(PAR_PROT_PAIRS):
            run = _par_pretrain(pcfg, params_to(pparams, DEV), pfeats, PAR_SHORT_STEPS,
                                PROT_TRAIN_BATCH, loss_fn=loss_fn, kernels=PROT_TRAINING_KERNELS)
            train, nu = _whole(run.pop("state"))
            pairs.append(_par_gap(f"ProtSTonKGs one rank, run {i + 2} vs run 1", run["losses"],
                                  train, _nu_sum(nu), ref_prot, pinit, PROT_UNUSED_LEAVES))
            del run, train, nu
            torch.cuda.empty_cache()
        prot_spread = (max(g[0] for g in pairs), min(g[1] for g in pairs),
                       min(g[2] for g in pairs), max(g[3] for g in pairs))
        log(f"# (c) ProtSTonKGs one-rank spreads {pairs!r}; the widest {prot_spread!r}")
        # the fp32 one-rank reference at 2 layers a stack
        pcfg32 = _prot_cfg(layers=PAR_PROT_FP32_LAYERS)
        p32 = _prot_params(pcfg32, seed=13)
        run = _par_pretrain(pcfg32, params_to(p32, DEV), pfeats, PAR_SHORT_STEPS,
                            PROT_TRAIN_BATCH, loss_fn=functools.partial(
                                protstonkgs.pretraining_loss, rand_attn=_train_plan(pcfg32)),
                            kernels=PROT_TRAINING_KERNELS, compute_dtype="float32")
        _par_reference(run, os.path.join(tmp, "ref_prot32.pt"))
        torch.save(p32, os.path.join(tmp, "pparams32.pt"))
        del run, p32
        torch.cuda.empty_cache()
        ccfg = _par_cfg(False).replace(num_labels=2)
        cfeats = _par_ft_features(ccfg)
        head0 = tree_flatten_with_path({"classifier": init_classifier_head(
            torch.Generator().manual_seed(4), ccfg.bert, 2)})
        ft = []
        for accum in (1, 2):
            run_cfg = dataclasses.replace(_par_ft_run(), batch_size=FT_BATCH // accum,
                                          gradient_accumulation=accum)
            state, metrics = finetuning.train_classifier(ccfg, params_to(params, DEV), cfeats,
                                                         run_cfg, rng_seed=3)
            ft.append(({"losses": [metrics["loss"]]}, state))
        train, nu = _whole(ft[0][1])
        ref_ft = {"losses": ft[0][0]["losses"], "nu_sum": _nu_sum(nu), "head0": head0,
                  "train": {k: t.cpu() for k, t in train.items()}}
        torch.save(ref_ft, os.path.join(tmp, "ref_ft.pt"))
        train, nu = _whole(ft[1][1])
        ft_spread = _par_gap("train_classifier one rank, accumulation 2", ft[1][0]["losses"],
                             train, _nu_sum(nu), ref_ft, {**init, **head0})
        del ft, train, nu, state
        torch.save(params, os.path.join(tmp, "params.pt"))
        torch.save(pparams, os.path.join(tmp, "pparams.pt"))
        os.makedirs(os.path.join(tmp, "feats"))
        for k, v in feats.items():
            np.save(os.path.join(tmp, "feats", k + ".npy"), v)
        store = os.path.join(tmp, "store")
        MemmapFeatureStore.write(store, _pretraining_features(cfg, PAR_STORE_ROWS, seed=25))
        torch.cuda.empty_cache()
        log(f"# (b) one-rank references and spreads: {time.perf_counter() - t0:.1f} s")

        # (b)-(e): two ranks on cuda:0 over gloo, launched with torchrun's variables
        job = {"params": os.path.join(tmp, "params.pt"), "pparams": os.path.join(tmp, "pparams.pt"),
               "feats": os.path.join(tmp, "feats"), "feat_keys": sorted(feats),
               "ref_on": os.path.join(tmp, "ref_on.pt"), "ref_off": os.path.join(tmp, "ref_off.pt"),
               "ref_prot": os.path.join(tmp, "ref_prot.pt"),
               "ref_prot32": os.path.join(tmp, "ref_prot32.pt"),
               "pparams32": os.path.join(tmp, "pparams32.pt"),
               "ref_ft": os.path.join(tmp, "ref_ft.pt"),
               "store": store, "run_dir": os.path.join(tmp, "run")}
        t0 = time.perf_counter()
        try:
            ranks = multihost.launch(_par_rank, 2, (job,), backend="gloo", timeout=900)
        except RuntimeError as e:
            raise SmokeFailure(f"phase 23's ranks: {e}") from e
        log(f"# (b)-(e) two ranks on cuda:0 over gloo: {time.perf_counter() - t0:.1f} s")
        run_records = _metric_records(job["run_dir"])

    for label, n_data, n_model, fsdp, dropout in PAR_MESHES:
        for r in ranks:
            res = r[label]
            _check_counts(f"(b) {label}, rank {r['rank']} ({PAR_STEPS} steps)", res["counts"],
                          {n: c * PAR_STEPS for n, c in per_step.items()})
            _check_losses(f"(b) {label}, rank {r['rank']}", res["losses"], PAR_STEPS)
            log(f"# (b) {label} rank {r['rank']}: peak above the start {res['peak_gb']!r} GB, "
                f"parameters and moments {res['state_gb']!r} GB; seconds a step after the first, "
                f"under gloo on a shared card (not a throughput): {res['step_s']!r} ({card})")
        check(ranks[0][label]["losses"] == ranks[1][label]["losses"],
              f"(b) {label}: the ranks logged different losses")
        check(ranks[0][label]["print"] == ranks[1][label]["print"],
              f"(b) {label}: the replicated leaves or moments differ between the ranks")
        _par_verdict(f"(b) {label}", ranks[0][label]["gap"], spread)
    _add_counts(total, ranks[0]["1x2 TP"]["counts"])
    log(f"# (b) per-rank peak memory above the start: 1x1 {meshed['peak_gb']!r} GB, 1x2 TP "
        f"{ranks[0]['1x2 TP']['peak_gb']!r} GB, 2x1 FSDP {ranks[0]['2x1 FSDP']['peak_gb']!r} GB; "
        f"parameters and moments a rank: 1x2 TP {ranks[0]['1x2 TP']['state_gb']!r} GB, 2x1 FSDP "
        f"{ranks[0]['2x1 FSDP']['state_gb']!r} GB, 2x1 DP {ranks[0]['2x1 DP']['state_gb']!r} GB "
        f"({card})")

    prot_step = _prot_training_per_step(pcfg)
    for r in ranks:
        res = r["prot 1x2"]
        _check_counts(f"(c) ProtSTonKGs 1x2, rank {r['rank']} ({PAR_SHORT_STEPS} steps)",
                      res["counts"], {n: c * PAR_SHORT_STEPS for n, c in prot_step.items()})
        _check_losses(f"(c) ProtSTonKGs 1x2, rank {r['rank']}", res["losses"], PAR_SHORT_STEPS)
        log(f"# (c) ProtSTonKGs 1x2 rank {r['rank']}: peak above the start {res['peak_gb']!r} GB, "
            f"state {res['state_gb']!r} GB, seconds a step after the first (not a throughput) "
            f"{res['step_s']!r}")
    check(ranks[0]["prot 1x2"]["print"] == ranks[1]["prot 1x2"]["print"],
          "(c) ProtSTonKGs: the replicated leaves or moments differ between the ranks")
    # fp32 first: the mesh against one rank with nothing but summation order
    # between them; only then the bf16 run against the spread of one rank
    for r in ranks:
        res = r["prot 1x2 fp32"]
        _check_counts(f"(c) ProtSTonKGs 1x2 fp32, rank {r['rank']} ({PAR_SHORT_STEPS} steps)",
                      res["counts"], {n: c * PAR_SHORT_STEPS for n, c in
                                      _prot_training_per_step(pcfg32).items()})
        _check_losses(f"(c) ProtSTonKGs 1x2 fp32, rank {r['rank']}", res["losses"],
                      PAR_SHORT_STEPS)
    check(ranks[0]["prot 1x2 fp32"]["print"] == ranks[1]["prot 1x2 fp32"]["print"],
          "(c) ProtSTonKGs fp32: the replicated leaves or moments differ between the ranks")
    gap32 = ranks[0]["prot 1x2 fp32"]["gap"]
    log(f"# (c) ProtSTonKGs 1x2 fp32 ({PAR_PROT_FP32_LAYERS} layers a stack) vs one rank: "
        f"largest relative loss gap {gap32[0]!r}, update cosine {gap32[1]!r} (limit "
        f"{PAR_FP32_UPDATE_COS}), lowest leaf {gap32[2]!r}, summed second moment gap "
        f"{gap32[3]!r}")
    check(gap32[1] >= PAR_FP32_UPDATE_COS,
          "(c) ProtSTonKGs 1x2 in fp32 is further from one rank than summation order allows")
    _par_verdict("(c) ProtSTonKGs 1x2", ranks[0]["prot 1x2"]["gap"], prot_spread)
    _add_counts(total, ranks[0]["prot 1x2"]["counts"])

    ft_steps = PAR_FT_ROWS // FT_BATCH
    for r in ranks:
        res = r["classifier 2x1"]
        _check_counts(f"(d) train_classifier 2x1, rank {r['rank']} ({ft_steps} steps)",
                      res["counts"], {n: c * ft_steps for n, c in per_step.items()})
        check(res["step"] == ft_steps and math.isfinite(res["metrics"]["loss"]),
              f"(d) rank {r['rank']}: {res['step']} steps, metrics {res['metrics']}")
    check(ranks[0]["classifier 2x1"]["print"] == ranks[1]["classifier 2x1"]["print"],
          "(d) train_classifier: the replicated leaves or moments differ between the ranks")
    _par_verdict("(d) train_classifier 2x1", ranks[0]["classifier 2x1"]["gap"], ft_spread)
    _add_counts(total, ranks[0]["classifier 2x1"]["counts"])

    for r in ranks:
        res = r["run_pretraining 1x2"]
        _check_counts(f"(e) run_pretraining, rank {r['rank']} ({PAR_STEPS} steps)",
                      res["counts"], {n: c * PAR_STEPS for n, c in per_step.items()})
        _check_counts(f"(e) run_pretraining resumed, rank {r['rank']} (2 steps)",
                      res["resumed_counts"], {n: c * 2 for n, c in per_step.items()})
        check(res["mesh"] == (1, 2) and res["step"] == PAR_STEPS,
              f"(e) rank {r['rank']}: mesh {res['mesh']}, step {res['step']}")
    check(ranks[0]["run_pretraining 1x2"]["print"] == ranks[1]["run_pretraining 1x2"]["print"],
          "(e) run_pretraining: the replicated leaves or moments differ between the ranks")
    losses = [(rec["step"], rec["value"]) for rec in run_records if rec["key"] == "loss"]
    res = ranks[0]["run_pretraining 1x2"]
    log(f"# (e) run_pretraining(n_model_shards=2): logged (main rank) {losses!r}; resumed at 2 "
        f"equals the uninterrupted run bit for bit: {res['equal']} (largest |diff| "
        f"{res['max_diff']!r})")
    check([s for s, _ in losses] == [1, 2, 3, 4, 3, 4], f"(e) logged steps {losses}")
    check(dict(losses[:4])[3] == losses[4][1] and dict(losses[:4])[4] == losses[5][1],
          "(e) the resumed run's losses differ from the uninterrupted run's")
    check(res["equal"], "(e) the resumed run's parameters differ from the uninterrupted run's")
    _add_counts(total, res["counts"])
    log(f"# parallel phase: {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# the mesh paths across cards (not part of main(): the driver's machine has
# one card; run it alone where several cards are visible)
# ---------------------------------------------------------------------------

PAR_CARD_STEPS = 6
# (label, n_data, n_model, fsdp, dropout), as PAR_MESHES
PAR_CARD_MESHES = (("2x2", 2, 2, False, False), ("4x1 FSDP", 4, 1, True, False),
                   ("4x1", 4, 1, False, False), ("1x4 TP", 1, 4, False, True))


def _par_card_rank(job: dict) -> dict:
    """One rank of ``phase_parallel_cards``: each mesh of
    ``PAR_CARD_MESHES`` for ``PAR_CARD_STEPS`` steps on this rank's card."""
    import torch.distributed as dist
    from stonkgs_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    out = {"rank": rank, "device": torch.cuda.current_device(), "backend": dist.get_backend()}
    params = torch.load(job["params"], weights_only=True)
    init = tree_flatten_with_path(split_frozen(params)[0])
    feats = {k: np.load(os.path.join(job["feats"], k + ".npy")) for k in job["feat_keys"]}
    for label, n_data, n_model, fsdp, dropout in PAR_CARD_MESHES:
        run = _par_pretrain(_par_cfg(dropout), params_to(params, DEV), feats, PAR_CARD_STEPS,
                            TRAIN_BATCH, mesh=make_mesh(n_data, n_model), fsdp=fsdp)
        state = run.pop("state")
        res = {**run, "state_gb": _state_gb(state), "print": _replica_print(state)}
        train, nu = _whole(state)
        if rank == 0:
            ref = torch.load(job["ref_on"] if dropout else job["ref_off"], weights_only=True)
            res["gap"] = _par_gap(label, run["losses"], train, _nu_sum(nu), ref, init)
        out[label] = res
        del state, train, nu
        torch.cuda.empty_cache()
    return out


def phase_parallel_cards(card: str, n_cards: int = 4, params: Optional[dict] = None) -> dict:
    """``pretrain`` on meshes over ``n_cards`` cards, one rank a card over
    NCCL (``PAR_CARD_MESHES``, phase 5's STonKGs, global B=32), each held
    to one rank as phase 23 holds its meshes (the spread: a one-rank run
    that sums its batch in ``n_data`` parts); prints seconds a step after
    the first beside one rank's, and each rank's parameter bytes and peak.
    Run alone: ``python3 -c "import chip_smoke as c; card = c.phase_device();
    c.phase_build(); c.phase_parallel_cards(card)"``.  Returns rank 0's
    launch counts."""
    from stonkgs_tpu_torch.parallel import multihost

    t_phase = time.perf_counter()
    check(torch.cuda.device_count() >= n_cards,
          f"{n_cards} cards needed, {torch.cuda.device_count()} visible")
    cfg = _par_cfg(True)
    if params is None:
        params = _stonkgs_params(cfg)
    feats = _pretraining_features(cfg, TRAIN_BATCH * PAR_CARD_STEPS, seed=23)
    per_step = _training_per_step(cfg.bert.num_hidden_layers)
    init = tree_flatten_with_path(split_frozen(params)[0])
    with tempfile.TemporaryDirectory(prefix="stonkgs_cards_") as tmp:
        one = {}
        for dropout in (True, False):
            run = _par_pretrain(_par_cfg(dropout), params_to(params, DEV), feats, PAR_CARD_STEPS,
                                TRAIN_BATCH)
            one[dropout] = (_par_reference(run, os.path.join(tmp, f"ref_{dropout}.pt")),
                            run["step_s"], run["peak_gb"], _state_gb(run["state"]))
            del run
        spreads = {}
        for parts in sorted({n_data for _, n_data, _, _, _ in PAR_CARD_MESHES} | {2}):
            if parts == 1:
                continue
            run = _par_pretrain(_par_cfg(False), params_to(params, DEV), feats, PAR_CARD_STEPS,
                                TRAIN_BATCH, accum=parts)
            train, nu = _whole(run.pop("state"))
            spreads[parts] = _par_gap(f"one rank, accumulation {parts}", run["losses"], train,
                                      _nu_sum(nu), one[False][0], init)
            del run, train, nu
        log(f"# one rank: seconds a step after the first {one[True][1]!r} (dropout on), "
            f"{one[False][1]!r} (off); peak above the start {one[True][2]!r} GB, parameters "
            f"and moments {one[True][3]!r} GB ({card})")
        torch.save(params, os.path.join(tmp, "params.pt"))
        os.makedirs(os.path.join(tmp, "feats"))
        for k, v in feats.items():
            np.save(os.path.join(tmp, "feats", k + ".npy"), v)
        torch.cuda.empty_cache()
        job = {"params": os.path.join(tmp, "params.pt"), "feats": os.path.join(tmp, "feats"),
               "feat_keys": sorted(feats), "ref_on": os.path.join(tmp, "ref_True.pt"),
               "ref_off": os.path.join(tmp, "ref_False.pt")}
        t0 = time.perf_counter()
        try:
            ranks = multihost.launch(_par_card_rank, n_cards, (job,), timeout=900)
        except RuntimeError as e:
            raise SmokeFailure(f"the ranks across cards: {e}") from e
        log(f"# {n_cards} ranks: {time.perf_counter() - t0:.1f} s; backends "
            f"{[r['backend'] for r in ranks]}, cards {[r['device'] for r in ranks]}")
    check(sorted(r["device"] for r in ranks) == list(range(n_cards)),
          "the ranks do not each hold a card of their own")
    for label, n_data, n_model, fsdp, dropout in PAR_CARD_MESHES:
        for r in ranks:
            res = r[label]
            _check_counts(f"{label} over {n_cards} cards, rank {r['rank']} ({PAR_CARD_STEPS} "
                          "steps)", res["counts"],
                          {n: c * PAR_CARD_STEPS for n, c in per_step.items()})
            _check_losses(f"{label}, rank {r['rank']}", res["losses"], PAR_CARD_STEPS)
        check(all(r[label]["losses"] == ranks[0][label]["losses"] for r in ranks),
              f"{label}: the ranks logged different losses")
        check(all(r[label]["print"] == ranks[0][label]["print"] for r in ranks),
              f"{label}: the replicated leaves or moments differ between the ranks")
        res = ranks[0][label]
        log(f"# {label} over {n_cards} cards ({ranks[0]['backend']}): seconds a step after "
            f"the first "
            f"{res['step_s']!r} against one rank's {one[dropout][1]!r}; parameters and moments "
            f"{res['state_gb']!r} GB a rank, peak above the start {res['peak_gb']!r} GB ({card})")
        _par_verdict(f"{label} over {n_cards} cards", res["gap"], spreads[max(n_data, 2)])
    log(f"# parallel phase across cards: {time.perf_counter() - t_phase:.1f} s")
    return ranks[0]["2x2"]["counts"]


# ---------------------------------------------------------------------------
# phase 24: the command line, the published-model API from a filled cache,
# layer remat and profiling
# ---------------------------------------------------------------------------

CLI_REMAT_BATCH = TRAIN_BATCH   # phase 5's model at B=32
CLI_REMAT_STEPS = 4
CLI_PROT_BATCH = 2
CLI_PROT_STEPS = 2
CLI_TIMER_BATCHES = 6
CLI_TIMER_GAP = 0.10     # StepTimer's p50 against CUDA-event timing of the same batches
CLI_INFER_TOL = 1e-6     # infer_species against predict_proba; the CLI's embed TSV
CLI_PARITY_TOL = 1e-3    # verify-parity on the card (fp32, TF32 off) against transformers
CLI_PARITY_FAULT = 1e-2  # the shift of cls.seq_relationship.bias the limit must reject


# a fault on the port's side only: its loader shifts the NSP bias (a
# shifted bias in the checkpoint itself would reach both sides of
# verify-parity, which read the same file)
CLI_FAULT = f"""
from stonkgs_tpu_torch.utils import hf_loader
_load = hf_loader.stonkgs_params_from_state_dict
def _shifted(*a, **kw):
    p = _load(*a, **kw)
    p["cls"]["seq_relationship"]["bias"] += {CLI_PARITY_FAULT!r}
    return p
hf_loader.stonkgs_params_from_state_dict = _shifted
import sys
from stonkgs_tpu_torch.cli import main
sys.exit(main(sys.argv[1:]))
"""


def _cli_start(args: list, env: dict, program=None) -> tuple:
    """Start ``python3 -m stonkgs_tpu_torch <args>`` (or ``python3 -c
    program <args>``) from the checkout's root; returns (the process, its
    start time) for :func:`_cli_wait`."""
    cmd = ["-m", "stonkgs_tpu_torch"] if program is None else ["-c", program]
    proc = subprocess.Popen([sys.executable, *cmd, *args], env=env,
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def _cli_wait(job: tuple, label: str, expect_rc: int = 0) -> str:
    """Wait for a command of :func:`_cli_start`; checks its exit code and
    returns its standard output."""
    proc, t0 = job
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeFailure(f"cli {label}: no exit within 600 s") from None
    shown = [ln for ln in out.splitlines() if not ln.startswith('{"type"')]
    log(f"# cli {label}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s; "
        f"output {shown[-4:]!r}")
    if proc.returncode != expect_rc:
        log(err[-4000:])
    check(proc.returncode == expect_rc,
          f"cli {label}: exit code {proc.returncode}, expected {expect_rc}")
    return out


def _cli(args: list, env: dict, label: str, expect_rc: int = 0, program=None) -> str:
    """One command of :func:`_cli_start`, waited for."""
    return _cli_wait(_cli_start(args, env, program), label, expect_rc)


def _cli_files(cfg: STonKGsConfig, cache_dir: str):
    """Phase 19's files, written where ``utils/cache.py::ensure`` maps the
    published URLs under ``cache_dir``: a checkpoint with a 3-class
    classifier at the species record's, the same without it at the hub's
    ``stonkgs/stonkgs-150k``, the node2vec TSVs and the vocabulary.
    Returns (rows, their paths)."""
    from stonkgs_tpu_torch import constants
    from stonkgs_tpu_torch.api import api
    from stonkgs_tpu_torch.utils import cache

    rng = np.random.default_rng(24)
    cfg3 = cfg.replace(num_labels=3)
    params = stonkgs.init_stonkgs_params(torch.Generator().manual_seed(24), cfg3,
                                         with_classifier=True)
    record = f"https://zenodo.org/record/{api.SPECIES_RECORD}/files"
    species = cache.cache_path(f"{record}/pytorch_model.bin", "species").parent
    save_pretrained(params, cfg3, str(species))
    with open(cache.cache_path(f"{record}/training_args.bin", "species"), "wb") as f:
        f.write(b"\0")           # ensure needs it to exist; nothing reads it
    hub = cache.cache_path("https://huggingface.co/stonkgs/stonkgs-150k/resolve/main/"
                           "pytorch_model.bin", "hub/stonkgs--stonkgs-150k").parent
    save_pretrained({k: v for k, v in params.items() if k != "classifier"}, cfg, str(hub))
    del params
    art = make_random_artifacts(README_ENTITIES, dim=cfg.bert.hidden_size,
                                rw_len=README_RW_LEN, seed=24)
    art.names = _bel_names(README_ENTITIES)
    art.name_to_idx = {n: i for i, n in enumerate(art.names)}
    emb, walks = cache.cache_path(constants.EMBEDDINGS_URL), cache.cache_path(constants.WALKS_URL)
    save_kg_artifacts(art, emb, walks)
    vocab = _readme_vocab(cfg.bert.vocab_size, rng)
    vocab_file = cache.cache_path(constants.VOCAB_URL, "misc")
    vocab_file.parent.mkdir(parents=True, exist_ok=True)
    vocab_file.write_text("\n".join(vocab) + "\n")
    rows = list(zip(*_readme_rows(art.names, vocab, rng)))
    check(all(str(p).startswith(cache_dir) for p in (species, hub, emb, walks, vocab_file)),
          "the cache's paths lie outside STONKGS_TPU_CACHE")
    return rows, {"species": str(species), "hub": str(hub), "emb": str(emb),
                  "walks": str(walks), "vocab": str(vocab_file)}


def _cli_published(rows: list, paths: dict, total: dict):
    """(a) ``from_default_pretrained`` -> ``embed`` with phase 5's launch
    counts; ``infer_species`` against ``predict_proba`` on the same files."""
    from stonkgs_tpu_torch.api import api

    cfg = STonKGsConfig(bert=BertConfig(), kg_vocab_size=README_ENTITIES)
    src, tgt, ev = (list(c) for c in zip(*rows))
    engine = STonKGsEngine.from_default_pretrained(batch_size=BATCH)
    check(engine.cfg == cfg and engine.device.type == torch.device(DEV).type,
          f"from_default_pretrained: {engine.cfg} on {engine.device}")
    feats = engine.preprocess(src, tgt, ev)
    _reset_counts(SERVING_KERNELS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = engine.embed(feats)
    first = time.perf_counter() - t1
    counts = _counts(SERVING_KERNELS)
    n_batches = math.ceil(len(rows) / BATCH)
    per_batch = cfg.bert.num_hidden_layers * 2 - 1
    _check_counts(f"from_default_pretrained embed ({n_batches} batches)", counts,
                  {n: per_batch * n_batches for n in counts})
    _add_counts(total, counts)
    check(out.shape == (len(rows), cfg.bert.hidden_size) and bool(np.isfinite(out).all()),
          f"from_default_pretrained embed: shape {out.shape} or not finite")

    api.get_species_model.cache_clear()
    header, *got = list(api.infer_species([list(r) for r in rows]))
    check(tuple(header) == ("source", "target", "evidence", *api.SPECIES_COLUMNS),
          f"infer_species header {header}")
    probs = np.asarray([r[3:] for r in got], np.float64)
    ref = STonKGsEngine.from_pretrained(paths["species"], paths["emb"], paths["walks"],
                                        vocab_file=paths["vocab"])
    want = ref.predict_proba(ref.preprocess(src, tgt, ev))
    sums = np.abs(probs.sum(1) - 1.0).max()
    err = float(np.abs(probs - want).max())
    log(f"# infer_species ({len(rows)} rows, on {api.get_species_model().device}): |sum - 1| "
        f"at most {sums!r} (limit 1e-5), against predict_proba of from_pretrained on the "
        f"same files max_abs_err {err!r} (limit {CLI_INFER_TOL})")
    check(probs.shape == (len(rows), 3) and sums <= 1e-5, "infer_species probabilities")
    check(err <= CLI_INFER_TOL, "infer_species differs from predict_proba")
    api.get_species_model.cache_clear()
    del ref
    return engine, feats, out


def _cli_commands(tmp: str, rows: list, paths: dict, out: np.ndarray, env: dict):
    """(b) the command line as subprocesses: ``embed``, both
    ``verify-parity`` runs and ``preprocess`` side by side (none reads
    another's output), and ``pretrain`` on what ``preprocess`` wrote as
    soon as it exits, beside the others."""
    version = _cli(["--version"], env, "--version").strip()
    check(version == "stonkgs-tpu-torch (dev)", f"--version printed {version!r}")
    rows_tsv = os.path.join(tmp, "rows.tsv")
    tsv_io.write_table(rows_tsv, {c: [r[i] for r in rows]
                                  for i, c in enumerate(("source", "target", "evidence"))})
    kg = ["--kg-embedding-path", paths["emb"], "--kg-walks-path", paths["walks"]]
    emb_tsv = os.path.join(tmp, "embeddings.tsv")
    parity = ["verify-parity", *kg, "--n_rows", "8", "--tolerance", str(CLI_PARITY_TOL),
              "--model_path", paths["species"]]
    triples = os.path.join(tmp, "triples.tsv")
    shutil.copy(rows_tsv, triples)
    pkl = os.path.join(tmp, "features.pkl")
    jobs = [_cli_start(["embed", "--input", rows_tsv, "--model_path", paths["hub"], *kg,
                        "--vocab-file", paths["vocab"], "--output", emb_tsv,
                        "--batch_size", str(BATCH)], env),
            _cli_start(parity, env),
            _cli_start(parity, env, program=CLI_FAULT),
            _cli_start(["preprocess", "--pretraining_path", triples, *kg,
                        "--vocab-file", paths["vocab"], "--output", pkl], env)]
    run_dir = os.path.join(tmp, "pretrain")
    try:
        printed = _cli_wait(jobs[3], "preprocess")
        check(f"to {pkl}" in printed, "preprocess's printed line")
        jobs.append(_cli_start(["pretrain", "--dataset", pkl, "--kg-embedding-path", paths["emb"],
                                "--vocab-file", paths["vocab"], "--max_steps", "2",
                                "--save_steps", "2", "--log_steps", "1",
                                "--num_hidden_layers", "2", "--remat", "full",
                                "--output_dir", run_dir], env))
        printed = _cli_wait(jobs[0], "embed")
        check(f"wrote {len(rows)} embeddings to {emb_tsv}" in printed, "embed's printed line")
        cli_emb = np.asarray([json.loads(c) for c in tsv_io.read_columns(
            emb_tsv, ["embedding"])["embedding"]], np.float32)
        err = float(np.abs(cli_emb - out).max())
        log(f"# cli embed TSV ({cli_emb.shape}) against the in-process embed of the same "
            f"engine: max_abs_err {err!r} (limit {CLI_INFER_TOL})")
        check(cli_emb.shape == out.shape and err <= CLI_INFER_TOL, "cli embed differs")
        printed = _cli_wait(jobs[1], "verify-parity")
        check(printed.startswith("PASS") and "cls " in printed, "verify-parity did not pass")
        printed = _cli_wait(jobs[2], f"verify-parity, the port's NSP bias shifted by "
                                     f"{CLI_PARITY_FAULT}", expect_rc=1)
        check(printed.startswith("FAIL") and "nsp 1.00e-02" in printed,
              "verify-parity accepted the shifted NSP bias")
        _cli_wait(jobs[4], "pretrain --remat full")
    finally:
        for proc, _ in jobs:   # none outlives a failed check
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    losses = {r["step"]: r["value"] for r in _metric_records(run_dir) if r["key"] == "loss"}
    log(f"# cli pretrain --remat full losses {losses!r}; checkpoints "
        f"{sorted(os.listdir(os.path.join(run_dir, 'checkpoints')))}")
    check(list(losses) == [1, 2] and all(math.isfinite(v) for v in losses.values()),
          "cli pretrain losses")
    check(os.path.isdir(os.path.join(run_dir, "checkpoints", "2")),
          "cli pretrain wrote no checkpoint")


def _remat_run(cfg, params_cpu: dict, feats: dict, steps: int, batch: int, remat, *,
               loss_fn=None, kernels=TRAINING_KERNELS) -> dict:
    """``steps`` train steps of ``make_train_step(remat=...)`` from the
    same parameters and seeds: the losses, the state, the launch counts,
    the peak memory above the start (GB) and the median ms of the steps
    after the first."""
    params = tree_map(lambda t: t.to(DEV, copy=True), params_cpu)  # the step updates in place
    tx = AdamW(learning_rate=1e-4, total_steps=steps)
    state = pretraining.init_train_state(params, tx, seed=0)
    step = pretraining.make_train_step(cfg, tx, loss_fn=loss_fn, compute_dtype=BF16,
                                       remat=remat)
    batches = [{k: host_to_device(v[i * batch:(i + 1) * batch], DEV) for k, v in feats.items()}
               for i in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    losses, seconds = [], []
    _reset_counts(kernels)
    for b in batches:
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        seconds.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return {"state": state, "losses": losses, "counts": _counts(kernels),
            "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "step_ms": statistics.median(seconds[1:]) * 1e3 if steps > 1 else None}


def _cli_remat(card: str, params: Optional[dict], pparams: Optional[dict], total: dict) -> dict:
    """(c) remat none / full / attention: STonKGs bit-equal, ProtSTonKGs
    within the spread of two none runs; peaks, step times and the
    recompute's launches."""
    cfg = STonKGsConfig(bert=BertConfig(), kg_vocab_size=100_000)
    check(cfg.bert.hidden_dropout_prob == 0.1 and cfg.bert.attention_probs_dropout_prob == 0.1,
          "phase 5's model is meant to train with dropout 0.1")
    if params is None:
        params = _stonkgs_params(cfg)
    feats = _pretraining_features(cfg, CLI_REMAT_BATCH * CLI_REMAT_STEPS, seed=24)
    L = cfg.bert.num_hidden_layers
    extra = {"none": {}, "full": {"flash_attention_train_fwd": L, "ffn_train_fwd": L},
             "attention": {"flash_attention_train_fwd": L}}
    runs = {}
    for mode in ("none", "full", "attention"):
        runs[mode] = run = _remat_run(cfg, params, feats, CLI_REMAT_STEPS, CLI_REMAT_BATCH,
                                      mode)
        per_step = _training_per_step(L)
        for name, c in extra[mode].items():
            per_step[name] += c
        _check_counts(f"remat {mode} ({CLI_REMAT_STEPS} steps, B={CLI_REMAT_BATCH})",
                      run["counts"], {n: c * CLI_REMAT_STEPS for n, c in per_step.items()})
        _add_counts(total, run["counts"])
        _check_losses(f"remat {mode}", run["losses"], CLI_REMAT_STEPS)
        log(f"# remat {mode}: peak above the start {run['peak_gb']!r} GB, step "
            f"{run['step_ms']!r} ms (median of steps 2-{CLI_REMAT_STEPS}) ({card})")
        if mode != "none":
            ref = tree_flatten_with_path(split_frozen(runs["none"]["state"].params)[0])
            got = tree_flatten_with_path(split_frozen(run["state"].params)[0])
            unequal = [k for k in ref if not torch.equal(ref[k], got[k])]
            log(f"# remat {mode} vs none: losses equal {run['losses'] == runs['none']['losses']}, "
                f"{len(ref) - len(unequal)} of {len(ref)} trainable leaves equal bit for bit")
            check(run["losses"] == runs["none"]["losses"] and not unequal,
                  f"remat {mode} differs from none: {unequal[:5]}")
            del run["state"]
        torch.cuda.empty_cache()
    del runs["none"]["state"]
    check(runs["full"]["peak_gb"] < runs["none"]["peak_gb"],
          "remat full does not lower the peak memory")
    log(f"# remat at B={CLI_REMAT_BATCH}: peak GB none {runs['none']['peak_gb']!r}, full "
        f"{runs['full']['peak_gb']!r}, attention {runs['attention']['peak_gb']!r}; step ms none "
        f"{runs['none']['step_ms']!r}, full {runs['full']['step_ms']!r}, attention "
        f"{runs['attention']['step_ms']!r} ({card})")

    pcfg = _prot_cfg()
    if pparams is None:
        pparams = _prot_params(pcfg, seed=1)
    pfeats = _prot_features(pcfg, CLI_PROT_BATCH * CLI_PROT_STEPS, seed=24, labels=True)
    loss_fn = functools.partial(protstonkgs.pretraining_loss, rand_attn=_train_plan(pcfg))
    init = tree_flatten_with_path(split_frozen(pparams)[0])
    prot = {}
    for label, mode in (("none", "none"), ("none again", "none"), ("attention", "attention")):
        run = _remat_run(pcfg, pparams, pfeats, CLI_PROT_STEPS, CLI_PROT_BATCH, mode,
                         loss_fn=loss_fn, kernels=PROT_ALL_KERNELS)
        per_step = _prot_training_per_step(pcfg)
        if mode == "attention":
            per_step["bigbird_mid_fwd"] += pcfg.trunk.num_hidden_layers
        _check_counts(f"ProtSTonKGs remat {label} ({CLI_PROT_STEPS} steps, B={CLI_PROT_BATCH})",
                      run["counts"], {n: c * CLI_PROT_STEPS for n, c in per_step.items()})
        _add_counts(total, run["counts"])
        _check_losses(f"ProtSTonKGs remat {label}", run["losses"], CLI_PROT_STEPS)
        train, nu = _whole(run["state"])
        prot[label] = {"losses": run["losses"], "nu_sum": _nu_sum(nu),
                       "train": {k: t.cpu() for k, t in train.items()}}
        log(f"# ProtSTonKGs remat {label}: peak above the start {run['peak_gb']!r} GB, step "
            f"{run['step_ms']!r} ms ({card})")
        del run, train, nu
        torch.cuda.empty_cache()
    ref = prot["none"]
    unused = PROT_UNUSED_LEAVES
    spread = _par_gap("ProtSTonKGs none vs none", prot["none again"]["losses"],
                      prot["none again"]["train"], prot["none again"]["nu_sum"], ref, init,
                      unused)
    gap = _par_gap("ProtSTonKGs attention vs none", prot["attention"]["losses"],
                   prot["attention"]["train"], prot["attention"]["nu_sum"], ref, init, unused)
    _par_verdict("ProtSTonKGs remat attention", gap, spread)
    return {m: {"peak_gb": r["peak_gb"], "step_ms": r["step_ms"]} for m, r in runs.items()}


def _cli_profiling(tmp: str, engine, feats: dict, card: str) -> None:
    """(d) ``utils/profiling.trace`` over one embed batch names the
    serving kernels; ``StepTimer`` against CUDA events over 6 batches."""
    from stonkgs_tpu_torch.utils import profiling

    batch = {k: v[:BATCH] for k, v in feats.items()}
    engine.embed(batch)
    trace_dir = os.path.join(tmp, "trace")
    with profiling.trace(trace_dir) as prof:
        with profiling.annotate("embed batch"):
            engine.embed(batch)
    with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    spans = [e for e in events if e.get("name") == "embed batch"]
    device_us = sum(e.get("dur", 0) for e in events if e.get("cat") == "kernel")
    log(f"# profiling.trace: {len(kernels)} kernel names, {device_us / 1e3!r} ms of kernel "
        f"time, {len(spans)} 'embed batch' spans; {len(prof.key_averages())} op rows")
    for want in ("gemm_sm90_kernel", "add_layer_norm_kernel", "attn_fwd_sm90_kernel"):
        check(any(want in k for k in kernels), f"the trace names no {want}")
    check(bool(spans), "the trace holds no annotated span")

    timer = profiling.StepTimer()
    events_ms = []
    for i in range(CLI_TIMER_BATCHES):
        chunk = {k: v[i * BATCH:(i + 1) * BATCH] if (i + 1) * BATCH <= len(v) else v[:BATCH]
                 for k, v in feats.items()}
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        timer.start()
        e0.record()
        engine.embed(chunk)
        e1.record()
        timer.stop()
        events_ms.append(e0.elapsed_time(e1))
    p50, ev = timer.p50 * 1e3, statistics.median(events_ms)
    log(f"# StepTimer p50 {p50!r} ms against CUDA events' median {ev!r} ms over "
        f"{CLI_TIMER_BATCHES} embed batches of {BATCH} ({card})")
    check(abs(p50 - ev) <= CLI_TIMER_GAP * ev, "StepTimer disagrees with CUDA events")


def phase_cli(card: str, params: Optional[dict] = None,
              pparams: Optional[dict] = None) -> dict:
    """Phase 24: the command line, the published-model API from a filled
    cache with no network, layer remat and profiling.  ``params`` and
    ``pparams`` are phase 5's and phase 11's CPU parameters (made here
    when not given).  Returns the phase's launch counts."""
    import urllib.request

    from stonkgs_tpu_torch.utils import cache

    t_phase = time.perf_counter()
    cfg = STonKGsConfig(bert=BertConfig(), kg_vocab_size=README_ENTITIES)
    total: dict = {}
    reached = []

    def no_network(url, *a, **kw):
        reached.append(url)
        raise OSError(f"phase 24 reaches no network ({url})")

    saved = (cache.CACHE_DIR, os.environ.get("STONKGS_TPU_CACHE"), urllib.request.urlretrieve)
    with tempfile.TemporaryDirectory(prefix="stonkgs_cli_") as tmp:
        cache_dir = os.path.join(tmp, "cache")
        cache.CACHE_DIR = Path(cache_dir)
        os.environ["STONKGS_TPU_CACHE"] = cache_dir
        urllib.request.urlretrieve = no_network
        try:
            t0 = time.perf_counter()
            rows, paths = _cli_files(cfg, cache_dir)
            log(f"# cli files written in {time.perf_counter() - t0:.1f} s under the cache "
                f"({_dir_gb(cache_dir)!r} GB)")
            engine, feats, out = _cli_published(rows, paths, total)
            check(not reached, f"the published-model API reached for {reached}")
            _cli_commands(tmp, rows, paths, out, dict(os.environ))
            _cli_profiling(tmp, engine, feats, card)
            del engine
            torch.cuda.empty_cache()
            _cli_remat(card, params, pparams, total)
        finally:
            cache.CACHE_DIR, env_cache, urllib.request.urlretrieve = saved
            if env_cache is None:
                os.environ.pop("STONKGS_TPU_CACHE", None)
            else:
                os.environ["STONKGS_TPU_CACHE"] = env_cache
    check(not reached, f"phase 24 reached for the network: {reached}")
    log(f"# cli phase: {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# widths: the kernels at head widths 16 and 32 and hidden widths other than
# 768 and 1024, STonKGs at MiniLM-L12-H384's widths, the CLI's narrow configs
# ---------------------------------------------------------------------------

# MiniLM-L12-H384 (Wang et al. 2020; microsoft/MiniLM-L12-H384-uncased,
# config.json): 12 layers of H=384, 12 heads of D=32, I=1536, vocabulary
# 30,522; STonKGs over it at the 256 + 256 layout, KG vocabulary 100,000
MINILM = dict(vocab_size=30522, hidden_size=384, num_hidden_layers=12, num_attention_heads=12,
              intermediate_size=1536)
WIDTH_HEAD_DIMS = (16, 32)
WIDTH_ATTN_S = (1, 63, 129, 300, 512)
WIDTH_FFN_H = (32, 64, 96, 384, 512)
WIDTH_FFN_M = (3, 129, 8192)
# the rows of I that the planted FFN faults of phase 26 (a) drop
WIDTH_FAULT_ROWS = 32
WIDTH_NARROW = (32, 64)      # the KG TSV widths whose configs run_pretraining derives
WIDTH_PF_ROWS = 2 * TRAIN_BATCH
WIDTH_PF_STEPS = 2
# bf16 against fp32 at MiniLM's widths, 24 layers deep: the cosine of the
# embeddings of all rows together, and of each row alone (at BERT-base, 4
# rows of phase 5 read 0.99989-0.99992 each against the CPU; at MiniLM's
# widths the lowest of 512 rows read 0.99988 on the card)
WIDTH_COS_ALL = 0.9999
WIDTH_COS_ROW = 0.9995
WIDTH_KERNELS = ("ffn_ln_block", "flash_attention_infer", "flash_attention_train_fwd",
                 "flash_attention_train_bwd", "ffn_train_fwd", "ffn_train_bwd")


def _minilm_cfg() -> STonKGsConfig:
    return STonKGsConfig(bert=BertConfig(**MINILM), kg_vocab_size=100_000)


def _widths_attention(gen, note) -> None:
    """(a) The attention kernels at D = 16 and 32 against their plain
    versions, bf16 and fp32: inference, the training forward at rates 0
    and 0.1 and the backward at both, at every S of WIDTH_ATTN_S, one
    head of one row (B=1) and B=8 with 12 heads whose batch row 0's keys
    are all at -1e9.  At rate 0.1 the forward's output limit must reject
    the plain output under another seed's mask (so the mask the kernel
    drew is the plain version's)."""
    for dtype in (BF16, F32):
        tag = "bf16" if dtype == BF16 else "fp32"
        for D in WIDTH_HEAD_DIMS:
            for S in WIDTH_ATTN_S:
                for B, H in ((1, 1), (8, 12)):
                    label = f"{tag} D={D} B={B} H={H} S={S}"
                    q, k, v, bias, _, seed, _ = _train_attn_inputs(B, S, dtype, gen, True, H, D)
                    if B > 1:
                        bias[0] = -1e9
                    e = _compare_attn(f"attention {label} mask", flash_attention_infer(
                        q, k, v, bias), flash_attention_infer_plain(q, k, v, bias), dtype)
                    note("flash_attention_infer", e, dtype)
                    for rate in (0.0, ATTN_RATE):
                        out, lse = flash_attention_train_fwd(q, k, v, bias, seed, rate)
                        out_p, lse_p = flash_attention_train_fwd_plain(q, k, v, bias, seed, rate)
                        e = max(_compare_attn(f"attention fwd {label} rate={rate}", out, out_p,
                                              dtype),
                                _compare(f"attention lse {label} rate={rate}", lse, lse_p, F32))
                        note("flash_attention_train_fwd", e, dtype)
                        if dtype == BF16 and rate > 0 and S == 512 and B > 1:
                            other = (seed + 1).to(torch.int32)
                            _attn_limit_rejects(
                                f"attention fwd {label} rate={rate} with another seed's mask",
                                out_p, flash_attention_train_fwd_plain(
                                    q, k, v, bias, other, rate)[0])
                        e = _attention_bwd_cases(tag, dtype, B, H, S, rate, gen, D)
                        note("flash_attention_train_bwd", e, dtype)
                    del q, k, v, bias


def _widths_ffn(gen, note) -> None:
    """(a) The three FFN kernels at every H of WIDTH_FFN_H, I = 4H, M = 3,
    129 and 8,192, gelu and gelu_new, bf16 and fp32, against their plain
    versions.  The weights are drawn at 1/sqrt(fan-in), so that outputs
    and gradients are of order 1 at every width and TOL is a small part
    of a typical value.  At M=8,192 in bf16 each limit must reject a
    known fault applied to the plain version: the last 32 rows of I
    dropped from the W2 product (ffn_ln, fwd) and from the W1ᵀ product
    (dx), and dh whose gelu' lacks its h-dependent term."""
    for dtype in (BF16, F32):
        tag = "bf16" if dtype == BF16 else "fp32"
        for H in WIDTH_FFN_H:
            for M in WIDTH_FFN_M:
                for act in ("gelu", "gelu_new"):
                    label = f"{tag} H={H} I={4 * H} M={M} {act}"
                    faults = dtype == BF16 and M == WIDTH_FFN_M[-1]
                    args = _ffn_inputs(M, dtype, gen, H, 4 * H, fan_in=True)
                    want = fused_ffn_ln_block_plain(*args, act=act)
                    e = _compare(f"ffn_ln {label}", fused_ffn_ln_block(*args, act=act), want,
                                 dtype)
                    note("ffn_ln_block", e, dtype)
                    if faults:
                        w2 = args[6].clone()
                        w2[-WIDTH_FAULT_ROWS:] = 0
                        _tol_rejects(f"ffn_ln {label} without W2's last {WIDTH_FAULT_ROWS} rows",
                                     want, fused_ffn_ln_block_plain(
                                         *args[:6], w2, *args[7:], act=act))
                    x, w1, b1, w2, b2, g = _train_ffn_inputs(M, dtype, gen, H, 4 * H,
                                                             fan_in=True)
                    want = fused_ffn_plain(x, w1, b1, w2, b2, act=act)
                    e = _compare(f"ffn fwd {label}", fused_ffn_fwd(x, w1, b1, w2, b2, act=act),
                                 want, dtype)
                    note("ffn_train_fwd", e, dtype)
                    if faults:
                        cut = w2.clone()
                        cut[-WIDTH_FAULT_ROWS:] = 0
                        _tol_rejects(f"ffn fwd {label} without W2's last {WIDTH_FAULT_ROWS} rows",
                                     want, fused_ffn_plain(x, w1, b1, cut, b2, act=act))
                    got = fused_ffn_bwd(x, g, w1, b1, w2, act=act)
                    want = fused_ffn_bwd_plain(x, g, w1, b1, w2, act=act)
                    e = max(_compare_rel(f"ffn dx {label}", got[0], want[0], dtype),
                            _compare_rel(f"ffn dh {label}", got[1], want[1], dtype),
                            _compare(f"ffn a {label}", got[2], want[2], dtype))
                    note("ffn_train_bwd", e, dtype)
                    if faults:
                        keep = 4 * H - WIDTH_FAULT_ROWS
                        _rel_limit_rejects(
                            f"ffn dx {label} without the last {WIDTH_FAULT_ROWS} rows of I",
                            want[0], (want[1][:, :keep].float()
                                      @ w1.to(dtype)[:, :keep].float().T).to(dtype))
                        _rel_limit_rejects(f"ffn dh {label} without the h-dependent term of "
                                           f"gelu'", want[1],
                                           _dh_without_h_term(x, g, w1, b1, w2, act))
                    del args, x, w1, b1, w2, b2, g, got, want


def _tol_rejects(name, want, wrong) -> None:
    """Fail unless TOL[want.dtype] tells ``wrong`` (a known kernel fault
    applied to the plain output) from ``want``."""
    g, w = wrong.float(), want.float()
    err = float((g - w).abs().max())
    ok = bool(torch.allclose(g, w, **TOL[want.dtype]))
    log(f"# check {name}: max_abs_err {err!r} max|plain| {float(w.abs().max())!r} "
        f"{'passes: FAIL' if ok else 'rejected: ok'}")
    check(not ok, f"{name}: TOL does not catch this fault")


def _refused(name, call) -> str:
    """The message of the ValueError that ``call`` raises ('' if none)."""
    try:
        call()
    except ValueError as e:
        return str(e)
    return ""


def _widths_outside(gen) -> None:
    """(a) Shapes outside the kernels' domain raise on the card in every
    wrapper and both dtypes, with no fallback to the plain versions and
    no launch counted: attention (inference, training forward and
    backward) at D = 0 and at S = 0 (``HEAD_OUTSIDE``: (S, D); any D from
    1 is phases 28's and 29's), the three FFN kernels at H = 0 and at I =
    0 (``WIDE_FFN_OUTSIDE``; any H and I from 1 are phase 29's); the
    BigBird pair's refused geometries are phase 10's and 27's
    (``_sparse_geometry_rejected``).  The C entry points refuse such
    widths themselves (cudaErrorInvalidValue, 1) without a launch: the
    attention and BigBird entry points at D = 0 and at D = 4, 36 and 68
    (the wrappers pad a D that is not a multiple of 8), the FFN ones at H
    = 0 or I = 0, in both dtypes."""
    counted = {**TRAINING_KERNELS, **SERVING_KERNELS}
    before = _counts(counted)
    for dtype in (BF16, F32):
        tag = "bf16" if dtype == BF16 else "fp32"
        for S, D in HEAD_OUTSIDE:
            q, k, v, bias, _ = _attn_inputs(1, S, dtype, gen, S > 0, 2, D)
            lse = torch.zeros(1, 2, S, device=DEV)
            for name, fn in (
                    ("flash_attention_infer", lambda: flash_attention_infer(q, k, v, bias)),
                    ("flash_attention_train_fwd",
                     lambda: flash_attention_train_fwd(q, k, v, bias)),
                    ("flash_attention_train_bwd",
                     lambda: flash_attention_train_bwd(q, k, v, bias, q, lse, q))):
                raised = _refused(name, fn)
                log(f"# check {name} {tag} at S={S} D={D} raises: {raised!r}")
                check("takes any D from 1 up and S >= 1" in raised,
                      f"{name} {tag} at S={S} D={D} did not raise")
        for H, I in WIDE_FFN_OUTSIDE:
            args = _ffn_inputs(3, dtype, gen, H, I)
            x, w1, b1, w2, b2, g = _train_ffn_inputs(3, dtype, gen, H, I)
            for name, fn in (("ffn_ln_block", lambda: fused_ffn_ln_block(*args)),
                             ("ffn_train_fwd", lambda: fused_ffn_fwd(x, w1, b1, w2, b2)),
                             ("ffn_train_bwd", lambda: fused_ffn_bwd(x, g, w1, b1, w2))):
                raised = _refused(name, fn)
                log(f"# check {name} {tag} at H={H} I={I} raises: {raised!r}")
                check("takes H and I from 1 up" in raised,
                      f"{name} {tag} at H={H} I={I} did not raise")
    after = _counts(counted)
    check(after == before, f"a refused width counted a launch: {before} -> {after}")
    # one zeroed buffer stands for every operand: the entry points must
    # return before they read it
    buf = torch.zeros(1 << 20, device=DEV)
    p, st = _build.ptr(buf), _build.stream(buf.device)
    drop = [0, 64, 0, 0, 0, 1.0]
    attn_lib = _build.load("flash_attention_infer", flash_attention_ops._SIGNATURES)
    train_lib = _build.load("flash_attention_train", flash_attention_ops._TRAIN_SIGNATURES)
    ln_lib = _build.load("ffn_ln_block", fused_ffn_ops._SIGNATURES)
    ffn_lib = _build.load("ffn_train", fused_ffn_ops._TRAIN_SIGNATURES)
    sparse_lib = _build.load("bigbird_sparse", bigbird_sparse_ops._SIGNATURES)
    for dt in (1, 0):
        tag = "bf16" if dt == 1 else "fp32"
        statuses = {}
        for D in WIDTHS_C_OUTSIDE:
            scale = max(D, 1) ** -0.5
            statuses.update({
                f"flash_attention_infer D={D}": attn_lib.flash_attention_infer(
                    dt, *[p] * 6, 1, 64, 2, D, scale, st),
                f"flash_attention_train_fwd D={D}": train_lib.flash_attention_train_fwd(
                    dt, *[p] * 7, 1, 64, 2, D, scale, *drop, st),
                f"flash_attention_train_bwd D={D}": train_lib.flash_attention_train_bwd(
                    dt, *[p] * 16, 1, 64, 2, D, 1, 64, scale, *drop, st)})
            S = 5 * 64
            statuses.update({
                f"bigbird_mid_fwd D={D}": sparse_lib.bigbird_mid_fwd(
                    dt, *[p] * 8, 1, S, 1, 1, 64, D, S * D, D, D, scale, st),
                f"bigbird_mid_bwd D={D}": sparse_lib.bigbird_mid_bwd(
                    dt, *[p] * 11, 1, S, 1, 1, 64, D, S * D, D, D, scale, st)})
        for H, I in WIDE_FFN_OUTSIDE:
            statuses.update({
                f"ffn_ln_block H={H} I={I}": ln_lib.ffn_ln_block(dt, *[p] * 13, 3, H, I, 0,
                                                                 1e-12, st),
                f"ffn_train_fwd H={H} I={I}": ffn_lib.ffn_train_fwd(dt, *[p] * 7, 3, H, I, 0, st),
                f"ffn_train_bwd H={H} I={I}": ffn_lib.ffn_train_bwd(dt, *[p] * 10, 3, H, I, 0,
                                                                    st)})
        if dt == 1:  # the bf16 kernels past the instances require their scratch
            statuses.update({
                "flash_attention_infer D=384 without stats": attn_lib.flash_attention_infer(
                    dt, *[p] * 5, None, 1, 64, 2, 384, 384 ** -0.5, st),
                "flash_attention_train_fwd D=384 without stats":
                    train_lib.flash_attention_train_fwd(dt, *[p] * 6, None, 1, 64, 2, 384,
                                                        384 ** -0.5, *drop, st),
                "flash_attention_train_bwd D=384 without its dS scratch":
                    train_lib.flash_attention_train_bwd(dt, *[p] * 12, None, None, None, None,
                                                        1, 64, 2, 384, 1, 64, 384 ** -0.5,
                                                        *drop, st),
                "flash_attention_train_bwd D=384 in chunks without the fp32 carries":
                    train_lib.flash_attention_train_bwd(dt, *[p] * 14, None, None, 1, 64, 2,
                                                        384, 1, 32, 384 ** -0.5, *drop, st),
                "bigbird_mid_fwd D=256 without stats": sparse_lib.bigbird_mid_fwd(
                    dt, *[p] * 7, None, 1, 5 * 64, 1, 1, 64, 256, 5 * 64 * 256, 256, 256,
                    256 ** -0.5, st)})
        torch.cuda.synchronize()
        for name, status in statuses.items():
            log(f"# check {name} {tag} C entry point: status {status} (1: refused)")
            check(status == 1, f"the C entry point {name} {tag} was not refused "
                               f"(status {status})")


def _widths_serving(cfg: STonKGsConfig) -> tuple:
    """(b) Phase 5 at MiniLM's widths (``embed`` parity and bucketed in
    bf16: launch counts, finite output, card fp32 against CPU fp32 on 4
    rows), then the card's fp32 engines on all rows (parity and bucketed,
    their launch counts), and bf16 against fp32 on the card by cosine.
    Returns (the bf16 parity engine, the rows, the parity counts)."""
    engine, bucketed, feats, counts, params = phase_serving(cfg)
    del bucketed
    out = engine.embed(feats)
    per_batch = cfg.bert.num_hidden_layers * 2 - 1
    n_batches = math.ceil(ROWS / BATCH)
    outs = {}
    for label, buckets in (("parity", None), ("bucketed", BUCKETS)):
        eng = STonKGsEngine(cfg=cfg, params=params_to(params, DEV), compute_dtype="float32",
                            batch_size=BATCH, length_buckets=buckets, device=DEV)
        _reset_counts(SERVING_KERNELS)
        outs[label] = eng.embed(feats)
        c = _counts(SERVING_KERNELS)
        log(f"# launches fp32 {label} embed (MiniLM widths): {c}")
        check(bool(np.isfinite(outs[label]).all()), f"fp32 {label} embed not finite")
        if buckets is None:
            check(all(n == per_batch * n_batches for n in c.values()),
                  f"fp32 parity embed launches {c}, expected {per_batch} x {n_batches}")
        else:
            check(all(n > 0 for n in c.values()), "fp32 bucketed embed skipped a kernel")
        del eng
    rows = _cosine(out, outs["parity"])
    whole = float(_cosine(out.reshape(1, -1), outs["parity"].reshape(1, -1))[0])
    log(f"# MiniLM widths, card bf16 vs card fp32 ({ROWS} rows): cosine of all rows "
        f"{whole!r} (limit {WIDTH_COS_ALL}), lowest row {float(rows.min())!r}, mean "
        f"{float(rows.mean())!r} (limit {WIDTH_COS_ROW} a row)")
    check(whole >= WIDTH_COS_ALL and bool((rows >= WIDTH_COS_ROW).all()),
          "MiniLM widths: bf16 embeddings too far from fp32")
    cb = _cosine(outs["bucketed"], outs["parity"])
    log(f"# MiniLM widths, fp32 bucketed vs parity: lowest cosine {float(cb.min())!r}")
    return engine, feats, counts, params


def _widths_pretrain_files(hidden: int, total: dict, variant: str = "stonkgs",
                           entities: Optional[int] = None, steps: int = WIDTH_PF_STEPS,
                           embed_rows: int = 0) -> None:
    """(d) ``run_pretraining`` from a memmap store and a ``hidden``-wide
    node2vec TSV of ``entities`` rows (README_ENTITIES by default; the
    config it derives: 2 layers, max(hidden // 64, 2) heads, I = 4
    hidden), ``steps`` steps of B=32 with an HF export, then
    ``from_pretrained`` -> ``embed`` on the card in fp32 against the CPU
    in fp32 (8 rows) and in bf16 by cosine; with ``embed_rows``, the card's
    bf16 embed runs over that many rows at B=128, its launches counted from
    0 just before it.  ``variant="transe"``: the TSV read as
    TransE vectors and the 508 + 4 layout that ``from_pretrained(variant=
    "transe")`` takes, one masked triple position a row."""
    t0 = time.perf_counter()
    entities = entities or README_ENTITIES
    tag = f"{hidden}-wide" + (" TransE" if variant == "transe" else "")
    with tempfile.TemporaryDirectory(prefix=f"stonkgs_w{hidden}_") as tmp:
        bert_cfg = BertConfig(hidden_size=hidden, num_hidden_layers=2,
                              num_attention_heads=max(hidden // 64, 2),
                              intermediate_size=hidden * 4)
        cfg = STonKGsConfig(bert=bert_cfg, kg_vocab_size=entities)
        if variant == "transe":
            cfg = cfg.replace(text_len=bert_cfg.max_position_embeddings - 4, entity_len=4)
        n_store = max(WIDTH_PF_ROWS, steps * TRAIN_BATCH)
        feats = _pretraining_features(cfg, max(n_store, embed_rows), seed=hidden)
        if variant == "transe":
            # int(0.15 * 4) = 0 masked triple positions: one a row, labelled
            # with its own id
            rng = np.random.default_rng(hidden)
            n = len(feats["input_ids"])
            rows_t, pos = np.arange(n), rng.integers(0, 4, n)
            feats["ent_masked_lm_labels"][rows_t, pos] = feats["input_ids"][
                rows_t, cfg.text_len + pos]
        store_dir = os.path.join(tmp, "store")
        MemmapFeatureStore.write(store_dir, {k: v[:n_store] for k, v in feats.items()})
        art = make_random_artifacts(entities, dim=hidden, rw_len=README_RW_LEN, seed=hidden)
        emb, walks = os.path.join(tmp, "emb.tsv"), os.path.join(tmp, "walks.tsv")
        save_kg_artifacts(art, emb, walks)
        vocab_file = os.path.join(tmp, "vocab.txt")
        with open(vocab_file, "w") as f:
            f.write("\n".join(_readme_vocab(bert_cfg.vocab_size,
                                            np.random.default_rng(hidden))) + "\n")
        derived = stonkgs_pretraining_config(feats, variant, hidden, bert_cfg.vocab_size)
        check(derived.bert == bert_cfg, f"run_pretraining derives {derived.bert}")
        check(flash_attention_ops.attention_kernel_takes(bert_cfg.head_dim)
              and fused_ffn_ops.ffn_kernel_takes(hidden, 4 * hidden),
              f"{hidden}-wide: the derived config is outside the kernels' domain")
        log(f"# {tag} KG TSV: run_pretraining derives H={hidden}, "
            f"{derived.bert.num_attention_heads} heads of D={derived.bert.head_dim}, "
            f"I={derived.bert.intermediate_size}, {derived.bert.num_hidden_layers} layers, "
            f"{entities} KG entities; files {time.perf_counter() - t0:.1f} s")
        out_dir, hf = os.path.join(tmp, "run"), os.path.join(tmp, "hf")
        _pf_run(f"run_pretraining {tag}", store_dir, out_dir, TRAINING_KERNELS,
                _training_per_step(bert_cfg.num_hidden_layers), list(range(1, steps + 1)),
                total, kg_embedding_path=emb, vocab_file=vocab_file, batch_size=TRAIN_BATCH,
                max_steps=steps, save_steps=steps, export_hf_dir=hf, variant=variant)
        keys = ("input_ids", "attention_mask", "token_type_ids")
        few = {k: feats[k][:8] for k in keys}
        got = {}
        for label, dev, dt in (("card fp32", DEV, "float32"), ("card bf16", DEV, "bfloat16"),
                               ("CPU fp32", "cpu", "float32")):
            t1 = time.perf_counter()
            wide = embed_rows and label == "card bf16"
            eng = STonKGsEngine.from_pretrained(hf, emb, walks, vocab_file=vocab_file,
                                                variant=variant, compute_dtype=dt,
                                                batch_size=BATCH if wide else 8, device=dev)
            check(eng.cfg.bert == bert_cfg and eng.cfg.seq_len == cfg.seq_len,
                  f"{label}: exported config {eng.cfg}")
            rows = {k: feats[k][:embed_rows] for k in keys} if wide else few
            _reset_counts(SERVING_KERNELS)
            out = eng.embed(rows)
            got[label] = out[:8]
            if dev == DEV:
                batches = math.ceil(len(out) / eng.batch_size)
                _check_counts(f"{tag} embed {label} ({len(out)} rows, {batches} batches)",
                              _counts(SERVING_KERNELS),
                              {n: (2 * bert_cfg.num_hidden_layers - 1) * batches
                               for n in SERVING_KERNELS})
                _add_counts(total, _counts(SERVING_KERNELS))
            check(bool(np.isfinite(out).all()), f"{tag} {label} embed not finite")
            log(f"# {tag} from_pretrained -> embed {label}: {time.perf_counter() - t1:.1f} s")
            del eng
        err = float(np.abs(got["card fp32"] - got["CPU fp32"]).max())
        cos = _cosine(got["card bf16"], got["CPU fp32"])
        log(f"# {tag} run_pretraining -> from_pretrained -> embed (8 rows): card fp32 vs "
            f"CPU fp32 max_abs_err {err!r} (limit 1e-3); card bf16 vs CPU fp32 lowest cosine "
            f"{float(cos.min())!r} (limit 0.99); {time.perf_counter() - t0:.1f} s")
        check(err <= 1e-3, f"{tag}: card fp32 embeddings disagree with the CPU")
        check(bool((cos >= 0.99).all()), f"{tag}: card bf16 too far from the CPU")


def _widths_times(cfg: STonKGsConfig, engine, feats, state, card: str) -> dict:
    """(e) The MiniLM embed's pairs/s (parity, 3 runs) and its step's ms
    (median of 6 after 2), then each kernel at the path's shapes beside
    its bound, plain version and the library call: attention D=32 at
    B=128, S=512 (trunk, masked) and S=256 (backbone), the training pair
    at B=32, S=512; the FFN at H=384, I=1536, M = 65,536 and 32,768
    (serving) and 16,384 and 8,192 (training).  Returns, per kernel, the
    trunk shape's numbers with the worse error of its shapes."""
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.embed(feats)
        times.append(time.perf_counter() - t0)
    check(bool(np.isfinite(out).all()), "MiniLM embed not finite")
    log(f"# embed MiniLM widths parity: {len(out)} rows, B={BATCH}, seconds {times!r}; best "
        f"{len(out) / min(times)!r} pairs/s, median {len(out) / statistics.median(times)!r} "
        f"pairs/s ({card})")
    med = _train_step_seconds(cfg, state, " MiniLM widths")
    log(f"# MiniLM widths step: {med * 1e3!r} ms ({card})")
    gen = torch.Generator(device=DEV).manual_seed(26)
    H, I, D, nh = cfg.bert.hidden_size, cfg.bert.intermediate_size, cfg.bert.head_dim, \
        cfg.bert.num_attention_heads
    sl, tl, B = cfg.seq_len, cfg.text_len, TRAIN_BATCH
    cases = {
        "ffn_ln_block": [
            (f"H={H} trunk M={BATCH * sl}", lambda lb: _time_ffn(lb, BATCH * sl, gen, H, I)),
            (f"H={H} backbone M={BATCH * tl}", lambda lb: _time_ffn(lb, BATCH * tl, gen, H, I))],
        "flash_attention_infer": [
            (f"D={D} trunk B={BATCH} S={sl} mask",
             lambda lb: _time_attention(lb, BATCH, sl, True, gen, nh, D)),
            (f"D={D} backbone B={BATCH} S={tl} no-bias",
             lambda lb: _time_attention(lb, BATCH, tl, False, gen, nh, D))],
        "flash_attention_train_fwd": [
            (f"D={D} trunk B={B} S={sl} mask",
             lambda lb: _time_train_attention(lb, B, sl, True, gen, False, nh, D))],
        "flash_attention_train_bwd": [
            (f"D={D} trunk B={B} S={sl} mask",
             lambda lb: _time_train_attention(lb, B, sl, True, gen, True, nh, D))],
        "ffn_train_fwd": [
            (f"H={H} trunk M={B * sl}", lambda lb: _time_train_ffn(lb, B * sl, gen, False, H, I)),
            (f"H={H} backbone M={B * tl}",
             lambda lb: _time_train_ffn(lb, B * tl, gen, False, H, I))],
        "ffn_train_bwd": [
            (f"H={H} trunk M={B * sl}", lambda lb: _time_train_ffn(lb, B * sl, gen, True, H, I))],
    }
    result = {}
    for name, shapes in cases.items():
        for i, (label, fn) in enumerate(shapes):
            t = fn(label)
            log(f"# time {name} {label} bf16 ({card}): {json.dumps(t)}")
            if i == 0:
                result[name] = t
            else:
                result[name]["max_abs_err"] = max(result[name]["max_abs_err"],
                                                  t["max_abs_err"])
    return result


def phase_widths(card: str) -> tuple:
    """Phase 26: (a) the kernels at the new widths against their plain
    versions and the shapes outside their domain refused, (b) MiniLM's
    embed, (c) its ``pretrain`` and training numerics, (d) the 32- and
    64-wide ``run_pretraining`` -> ``embed``, (e) times.  Returns (the
    launch counts of every counted run, summed; the counts of the MiniLM
    embed and step; per kernel, the worst bf16 error at the new widths;
    per kernel, the MiniLM shapes' times)."""
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(25)
    errs: dict = {}

    def note(name, err, dtype):
        if dtype == BF16:
            errs[name] = max(errs.get(name, 0.0), err)

    _widths_attention(gen, note)
    _widths_ffn(gen, note)
    _widths_outside(gen)
    log(f"# widths (a) kernels: {time.perf_counter() - t_phase:.1f} s")
    cfg = _minilm_cfg()
    engine, feats, counts, params = _widths_serving(cfg)
    minilm_counts = dict(counts)
    train_counts, state = phase_training(cfg, params)
    minilm_counts.update(train_counts)
    phase_train_numerics(cfg)
    log(f"# widths (b, c) MiniLM: {time.perf_counter() - t_phase:.1f} s")
    total = dict(minilm_counts)
    for hidden in WIDTH_NARROW:
        _widths_pretrain_files(hidden, total, entities=WIDE_ENTITIES)
    times = _widths_times(cfg, engine, feats, state, card)
    del engine, state, params
    torch.cuda.empty_cache()
    log(f"# widths phase: {time.perf_counter() - t_phase:.1f} s")
    return total, minilm_counts, errs, times


# ---------------------------------------------------------------------------
# phase 27: the BigBird pair at head widths 16 and 32 and every block size
# the command line derives; ProtSTonKGs from a 128-wide KG TSV
# ---------------------------------------------------------------------------

BB_R = 1                 # the command line's num_random_blocks
# (block size, D, B, H, nb, padded) of the pair's checks: the CLI's
# block = S // 8 over S = 64 ... 8,192 at D=32 (3 heads, a padded mask),
# the smallest block-sparse S at a partial block (nb=5, 2 heads), and D=16
# (4 heads); each at the eval and the training plan
BB_CASES = (tuple((bs, 32, 2, 3, 8, True) for bs in (8, 48, 64, 96, 128, 256, 512, 1024))
            + ((96, 32, 2, 2, 5, False), (64, 16, 2, 4, 8, True), (512, 16, 2, 4, 8, True)))
# past the old block rule (multiples of 8 up to 1,024): the command line's
# blocks at S = 32 (4), 96 (12), 200 (25), 800 (100), 8,256 (1,032) and
# 16,384 (2,048) at D=32, block 4 at the 8-wide configs' D = 4, and block
# 25 at nb = 5 (S = 125)
BB_ANY_CASES = (tuple((bs, 32, 2, 3, 8, True) for bs in (4, 12, 25, 100, 1032, 2048))
                + ((4, 4, 2, 2, 8, True), (25, 32, 2, 2, 5, False)))
BB_FAULT_BLOCKS = (96, 512, 25)   # partial block sizes and the path's
BB_DROP_FAULT = 25                # the block whose slots lose their last key
BB_KG_NODES = 20_000     # the synthetic node2vec TSVs' rows
BB_STEPS = 2             # steps of each run_pretraining
BB_BATCH = 2
BB_ROWS = 32             # rows embedded at B = BB_EMBED_BATCH
BB_EMBED_BATCH = 8
BB_CPU_ROWS = 2          # of which the CPU embeds these (and 1 at S = BB_LONG_S)
# (KG TSV width, text | entity | protein lengths) of the path's runs: the
# reference layout at a 128-wide TSV (D=32, block 512) and a 32-wide one
# (D=16), and a 768-token layout (block 96; the text splits into the 3
# chunks of the frozen BioBERT)
BB_PATHS = ((128, (768, 256, 3072)), (32, (768, 256, 3072)), (128, (384, 128, 256)))
# (KG TSV width, layout) of the stores past the old block rule, 4 steps of
# B=2 each: S = 200 from a 64-wide TSV (block 25, 2 heads of 32), S = 32
# from an 8-wide one (block 4, 2 heads of D = 4 in the trunk and both
# backbones) and S = 16,384 from a 32-wide one (block 2,048, 2 heads of
# 16; the entities, which the KG table gathers, take the length, so that
# the CPU's checks of the backbones stay short); the CPU checks 1 row at
# S = 16,384
BB_ANY_PATHS = ((64, (96, 48, 56)), (8, (12, 8, 12)), (32, (384, 15616, 384)))
BB_ANY_STEPS = 4
BB_LONG_S = 16384
# ProtSTonKGs at its published widths with the trunk's 768 in 6 heads of
# D = 128, on phase 11's parameters: embed BB_HEADS_ROWS rows at B=8
BB_HEADS_128 = 6
BB_HEADS_ROWS = 16


def _bb_extra(bs: int) -> int:
    """Rows (keys) past a block that a 64-row tile would hold: the rest of
    its last tile, or one tile past a block of whole tiles."""
    return (-bs) % 64 or 64


def _sparse_fwd_fault(q, k, v, mask, rand, bs, extra=0, round2=True, scale_d=None):
    """The plain forward with a known fault: every slot widened by
    ``extra`` keys past its block (the keys that follow it, with their
    mask's penalty, zeros and -10000 past S), (``round2=False``) the
    scaled logit not rounded again, or (``scale_d``) the logit scale of
    head width ``scale_d`` (a padded instance's width) in place of the
    tensors' D."""
    B, S, H, D = q.shape
    nb = S // bs
    dt, f = q.dtype, torch.float32
    idx = bigbird_sparse_ops._slot_blocks(nb, rand)              # (H, n, 5+r)
    n_mid, slots = idx.shape[1], idx.shape[2]
    w = bs + extra
    keys = idx[..., None] * bs + torch.arange(w, device=q.device)  # (H, n, slots, w)
    kp, vp = (F.pad(t, (0, 0, 0, 0, 0, extra)).transpose(1, 2) for t in (k, v))  # (B, H, S+e, D)
    hix = torch.arange(H, device=q.device)[:, None, None, None]
    kc = kp[:, hix, keys].reshape(B, H, n_mid, slots * w, D)
    vc = vp[:, hix, keys].reshape(B, H, n_mid, slots * w, D)
    gm = F.pad(mask.float(), (0, extra))[:, keys]                   # (B, H, n, slots, w)
    gm[:, :, 0, 1] = 0.0
    gm[:, :, n_mid - 1, 3] = 0.0
    pen = ((1.0 - gm) * bigbird_sparse_ops.ATTN_PENALTY).reshape(B, H, n_mid, 1, slots * w)
    qm = _blocked(q, bs)[:, :, 1:-1]
    s = torch.einsum("bhjqd,bhjkd->bhjqk", qm.to(f), kc.to(f)).to(dt)
    scale = bigbird_sparse_ops._scale_in(dt, scale_d or D)
    if round2:
        logits = (s * scale).to(f) + pen
    else:
        logits = s.to(f) * float(scale) + pen
    wgt = torch.softmax(logits, dim=-1).to(dt)
    ctx = torch.einsum("bhjqk,bhjkd->bhjqd", wgt.to(f), vc.to(f)).to(dt)
    return ctx.permute(0, 2, 3, 1, 4).reshape(B, n_mid * bs, H, D)


def _sparse_fwd_drop_last(q, k, v, mask, rand, bs):
    """The plain forward with a known fault: the last key of every slot
    left out of the softmax."""
    B, S, H, D = q.shape
    qm, kc, vc, pen, _ = _mid_operands(q, k, v, mask, rand, bs)
    pen = pen.clone()
    pen[..., bs - 1::bs] = -math.inf
    wgt = torch.softmax(_mid_logits(qm, kc, pen, q.dtype), dim=-1).to(q.dtype)
    ctx = torch.einsum("bhjqk,bhjkd->bhjqd", wgt.float(), vc.float()).to(q.dtype)
    return ctx.permute(0, 2, 3, 1, 4).reshape(B, -1, H, D)


def _dk_with_rows_past(q, k, v, mask, rand, bs, out, lse, do, dk, extra):
    """dK with a known fault: each middle query block's ``extra`` rows past
    it (the next middle block's first rows, with their own q, dO, O and
    lse) let into its slots' dK, as a kernel that did not zero their P and
    dS would add them."""
    B, S, H, D = q.shape
    nb = S // bs
    f = torch.float32
    qm, kc, vc, pen, idx = _mid_operands(q, k, v, mask, rand, bs)
    n = idx.shape[1] - 1       # the last middle block has no middle rows after it
    rows = ((torch.arange(n, device=q.device)[:, None] + 1) * bs
            + torch.arange(extra, device=q.device))                    # (n, extra) middle rows
    per_head = lambda t: t.permute(0, 3, 1, 2, 4)  # noqa: E731 (B, n, e, H, D) -> (B, H, n, e, D)
    qx, dox, ox = (per_head(t[:, rows]).to(f) for t in (q[:, bs:], do, out))
    lsex = lse[:, :, rows]                                              # (B, H, n, extra)
    logits = _mid_logits(qx.to(q.dtype), kc[:, :, :n], pen[:, :, :n], q.dtype)
    p = torch.exp(logits - lsex[..., None])
    dp = torch.einsum("bhjqd,bhjkd->bhjqk", dox, vc[:, :, :n].to(f))
    ds = p * (dp - (dox * ox).sum(-1, keepdim=True)) / math.sqrt(D)
    dkc = torch.einsum("bhjqk,bhjqd->bhjkd", ds, qx)                   # (B, H, n, W, D)
    acc = torch.zeros(B, H, nb, bs, D, dtype=f, device=q.device)
    bix = torch.arange(B, device=q.device)[:, None, None, None]
    hix = torch.arange(H, device=q.device)[None, :, None, None]
    acc.index_put_((bix, hix, idx[None, :, :n]), dkc.reshape(B, H, n, -1, bs, D),
                   accumulate=True)
    return (dk.float() + acc.permute(0, 2, 3, 1, 4).reshape(B, S, H, D)).to(dk.dtype)


def _integer_qkv(B, S, H, D, gen):
    """q and k of small integers (exact in bf16, their products' sums exact
    in fp32 in any order, so the kernel's and the plain version's rounded
    Q·Kᵀ are bit-equal) and v of normal draws, in bf16 on the card: logits
    of order 10-60, where the scale's second rounding moves them by up to
    half a bf16 step (0.06-0.25)."""
    q, k = (torch.randint(-6, 7, (B, S, H, D), generator=gen).to(DEV, BF16) for _ in range(2))
    v = torch.randn(B, S, H, D, generator=gen).to(DEV, BF16)
    return q, k, v


def _bb_faults(gen, bs: int) -> None:
    """(a) At block ``bs`` (D=32, the training plan, an unpadded mask, B=2,
    H=3, nb=8, bf16) the limits the pair is held to must reject: a key past
    the block let into the softmax, a query row past the block let into dK
    (``_bb_extra`` of them: the rest of a partial tile, or one tile; the
    next block's rows only, at most bs, where the tile holds several
    blocks), and the scale's second rounding left out (on integer-valued q
    and k, where the kernel is held to the same limits first)."""
    extra = _bb_extra(bs)
    rows = min(extra, bs)
    label = f"bf16 D=32 bs={bs} train plan"
    q, k, v, mask, rand, do = _sparse_inputs(2, 8, BF16, gen, "train", False, 3, bs, 32, BB_R)
    out, lse = bigbird_mid_fwd_plain(q, k, v, mask, rand, bs)
    _attn_limit_rejects(f"sparse fwd {label} with {extra} keys past the block", out,
                        _sparse_fwd_fault(q, k, v, mask, rand, bs, extra=extra))
    dk = bigbird_mid_bwd_plain(q, k, v, mask, rand, bs, out, lse, do)[1]
    _grad_limit_rejects(f"sparse dk {label} with {rows} query rows past the block", dk,
                        _dk_with_rows_past(q, k, v, mask, rand, bs, out, lse, do, dk, rows))
    q, k, v = _integer_qkv(2, 8 * bs, 3, 32, gen)
    want = bigbird_mid_fwd_plain(q, k, v, mask, rand, bs)[0]
    _compare_attn(f"sparse fwd {label} integer q, k", bigbird_mid_fwd(q, k, v, mask, rand, bs)[0],
                  want, BF16)
    _attn_limit_rejects(f"sparse fwd {label} integer q, k without the second rounding", want,
                        _sparse_fwd_fault(q, k, v, mask, rand, bs, round2=False))


def _bb_cases(cases, gen, note) -> None:
    """The pair against its plain versions at every (block size, D, B, H,
    nb, padded mask) of ``cases``, bf16 and fp32, forward (lse too) and
    backward, at the eval and the training plan."""
    for bs, D, B, H, nb, padded in cases:
        for dtype in (BF16, F32):
            tag = "bf16" if dtype == BF16 else "fp32"
            for plan in ("eval", "train"):
                q, k, v, mask, rand, do = _sparse_inputs(B, nb, dtype, gen, plan, padded, H, bs,
                                                         D, BB_R)
                label = (f"{tag} D={D} bs={bs} B={B} H={H} S={nb * bs} {plan} plan"
                         f"{' mask' if padded else ''}")
                out, lse = _bb_wide_route(label, D, dtype,
                                          lambda: bigbird_mid_fwd(q, k, v, mask, rand, bs))
                out_p, lse_p = bigbird_mid_fwd_plain(q, k, v, mask, rand, bs)
                e = max(_compare_attn(f"sparse fwd {label}", out, out_p, dtype),
                        _compare(f"sparse lse {label}", lse, lse_p, dtype))
                note("bigbird_mid_fwd", e, dtype)
                got = bigbird_mid_bwd(q, k, v, mask, rand, bs, out_p, lse_p, do)
                want = bigbird_mid_bwd_plain(q, k, v, mask, rand, bs, out_p, lse_p, do)
                e = max(_compare_grad(f"sparse {n} {label}", g, w, dtype)
                        for n, g, w in zip(("dq", "dk", "dv"), got, want))
                note("bigbird_mid_bwd", e, dtype)
                del q, k, v, out, lse, out_p, lse_p, got, want


def _bb_kernels(gen, note) -> None:
    """(a) The pair against its plain versions at every case of
    ``BB_CASES`` and ``BB_ANY_CASES`` (``_bb_cases``); the faults at
    ``BB_FAULT_BLOCKS``, and at block ``BB_DROP_FAULT`` (D=32, the
    training plan, bf16) the plain output with the last key of every slot
    dropped; the geometries outside the domain refused."""
    _bb_cases(BB_CASES + BB_ANY_CASES, gen, note)
    for bs in BB_FAULT_BLOCKS:
        _bb_faults(gen, bs)
    bs = BB_DROP_FAULT
    q, k, v, mask, rand, _ = _sparse_inputs(2, 8, BF16, gen, "train", True, 3, bs, 32, BB_R)
    _attn_limit_rejects(f"sparse fwd bf16 D=32 bs={bs} train plan without the last key of "
                        f"every slot", bigbird_mid_fwd_plain(q, k, v, mask, rand, bs)[0],
                        _sparse_fwd_drop_last(q, k, v, mask, rand, bs))
    _sparse_geometry_rejected(gen)


def _bb_layout_cfg(kg_nodes: int, layout: tuple) -> ProtSTonKGsConfig:
    """Phase 11's config at another text | entity | protein layout (the
    features' shape; the widths are derived from the TSV)."""
    tl, el, pl = layout
    return dataclasses.replace(_prot_cfg(kg_nodes), kg_start_idx=tl, prot_start_idx=tl + el,
                               seq_len=tl + el + pl)


def _bb_path(width: int, layout: tuple, emb: str, tmp: str, total: dict,
             steps: int = BB_STEPS) -> tuple:
    """(b) ``run_pretraining(variant="prot")`` from a memmap store and a
    ``width``-wide node2vec TSV at ``layout``: the derived config (heads of
    32, or 2 of 16; block max(S // 8, 4); r = 1) in the kernels' domain,
    ``steps`` steps of B=2 with one save (launch counts, finite losses,
    frozen trees unchanged), loss and trunk gradients card fp32 against
    CPU fp32 (phase 13's limits), then ``ProtSTonKGsEngine.embed`` on the
    trained parameters (32 rows at B=8, launch counts): card fp32 against
    CPU fp32 on one batch, card bf16 against card fp32 by cosine (phase
    26's limits).  At S = BB_LONG_S the CPU's checks take 1 row.  Returns
    (the derived config, the trained state, the bf16 engine, the rows)."""
    t0 = time.perf_counter()
    S = sum(layout)
    tag = f"{width}-wide TSV, S={S}"
    cpu_rows = 1 if S >= BB_LONG_S else BB_CPU_ROWS
    feats = _prot_features(_bb_layout_cfg(BB_KG_NODES, layout), BB_BATCH * steps, seed=width,
                           labels=True)
    ent = feats["input_ids"][:, layout[0]:layout[0] + layout[1]]
    ent %= BB_KG_NODES            # entity ids index the TSV's nodes, all of which the
    ent[0, 0] = BB_KG_NODES - 1   # derived KG vocabulary covers (the labels' range)
    cfg = prot_pretraining_config(feats, width)
    check(cfg.kg_vocab_size == BB_KG_NODES, f"{tag}: KG vocabulary {cfg.kg_vocab_size}")
    t = cfg.trunk
    log(f"# {tag}: run_pretraining derives the trunk {t.num_hidden_layers} x {t.hidden_size}, "
        f"{t.num_attention_heads} heads of D={t.head_dim}, I={t.intermediate_size}, "
        f"{t.hidden_act}, block {t.block_size}, r={t.num_random_blocks}; the backbones "
        f"{cfg.lm.num_attention_heads} and {cfg.prot.num_attention_heads} heads of "
        f"D={cfg.lm.head_dim}")
    check(bigbird_sparse_ops.bigbird_kernel_takes(t.block_size, t.head_dim, S)
          and t.num_random_blocks == BB_R, f"{tag}: the derived trunk is outside the pair's "
                                           f"domain: {t}")
    check(flash_attention_ops.attention_kernel_takes(cfg.lm.head_dim)
          and flash_attention_ops.attention_kernel_takes(cfg.prot.head_dim)
          and fused_ffn_ops.ffn_kernel_takes(width, 4 * width),
          f"{tag}: a derived backbone is outside the dense kernels' domain")
    store = os.path.join(tmp, f"store{width}_{S}")
    MemmapFeatureStore.write(store, feats)
    out_dir = os.path.join(tmp, f"run{width}_{S}")
    state, _, _, _ = _pf_run(f"run_pretraining prot {tag}", store, out_dir,
                             PROT_TRAINING_KERNELS, _prot_training_per_step(cfg),
                             list(range(1, steps + 1)), total, variant="prot",
                             kg_embedding_path=emb, batch_size=BB_BATCH, max_steps=steps,
                             save_steps=steps)
    check(CheckpointManager(os.path.join(out_dir, "checkpoints")).steps() == [steps],
          f"{tag}: checkpoints")
    params = params_to(state.params, "cpu", F32)
    frozen = split_frozen(params)[1]
    init = protstonkgs.init_protstonkgs_params(torch.Generator().manual_seed(0), cfg)
    for name in ("lm_backbone", "prot_backbone"):
        same = all(torch.equal(a, b.to(BF16).float()) for a, b in
                   zip(tree_leaves(frozen[name]), tree_leaves(init[name])))
        check(same, f"{tag}: the frozen {name} changed")
    if S < BB_LONG_S:   # at block 2,048 the pair is held to its plain versions in (a)
        _bb_train_numerics(cfg, params, tag)

    rows = _prot_features(cfg, BB_EMBED_BATCH if S >= BB_LONG_S else BB_ROWS, seed=width + 1)
    engines = {}
    got = {}
    for label, dev, dt in (("card bf16", DEV, BF16), ("card fp32", DEV, F32)):
        engines[label] = ProtSTonKGsEngine(cfg=cfg, params=params_to(params, dev, dt),
                                           compute_dtype="bfloat16" if dt == BF16 else "float32",
                                           batch_size=BB_EMBED_BATCH, device=dev)
        got[label], counts = _prot_embed_counted(f"{tag} embed {label}", engines[label], rows)
        _add_counts(total, counts)
    few = {k_: v[:cpu_rows] for k_, v in rows.items()}
    cpu = ProtSTonKGsEngine(cfg=cfg, params=params, compute_dtype="float32",
                            batch_size=BB_EMBED_BATCH, device="cpu").embed(few)
    err = float(np.abs(got["card fp32"][:cpu_rows] - cpu).max())
    scale = float(np.abs(cpu).max())
    cos = _cosine(got["card bf16"], got["card fp32"])
    whole = float(_cosine(got["card bf16"].reshape(1, -1), got["card fp32"].reshape(1, -1))[0])
    log(f"# {tag} embed: card fp32 vs CPU fp32 ({cpu_rows} rows) max_abs_err {err!r} of "
        f"max |CPU| {scale!r} (limit 1e-3 of it); card bf16 vs card fp32 ({BB_ROWS} rows) "
        f"cosine of all rows {whole!r} (limit {WIDTH_COS_ALL}), lowest row "
        f"{float(cos.min())!r} (limit {WIDTH_COS_ROW}); {time.perf_counter() - t0:.1f} s")
    check(err <= 1e-3 * scale, f"{tag}: card fp32 embeddings disagree with the CPU")
    check(whole >= WIDTH_COS_ALL and bool((cos >= WIDTH_COS_ROW).all()),
          f"{tag}: card bf16 embeddings too far from fp32")
    del engines["card fp32"]
    return cfg, state, engines["card bf16"], rows


def _bb_train_numerics(cfg: ProtSTonKGsConfig, params: dict, tag: str) -> None:
    """(b) The loss and the trunk's and projection's gradients at the
    trained parameters on 2 rows, card fp32 against CPU fp32 (phase 13's
    limits: 1e-4 relative, 1e-3 of max |grad|), the training plan, hidden
    dropout 0 (the card's and the CPU's generators draw other masks) and
    the backbones' hash attention dropout on the same seeds."""
    zero = {"hidden_dropout_prob": 0.0}
    cfg = cfg.replace(trunk=dataclasses.replace(cfg.trunk, **zero),
                      lm=dataclasses.replace(cfg.lm, **zero),
                      prot=dataclasses.replace(cfg.prot, **zero))
    feats = _prot_features(cfg, 2, seed=5, labels=True)

    def loss_and_grads(device):
        p = params_to(params, device)
        leaves = tree_leaves(p["trunk"]) + tree_leaves(p["prot_projection"])
        for x in leaves:
            x.requires_grad_(True)
        loss, _ = protstonkgs.pretraining_loss(
            p, cfg, pretraining.to_device(feats, device), deterministic=False,
            rng=pretraining.step_rng(0, 0, device), compute_dtype=F32)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return float(loss.detach()), [g.detach().cpu() for g in grads if g is not None]

    launches = bigbird_mid_bwd.launches
    loss_card, g_card = loss_and_grads(DEV)
    check(bigbird_mid_bwd.launches > launches, f"{tag}: the card run launched no sparse backward")
    loss_cpu, g_cpu = loss_and_grads("cpu")
    err = max(float((a - b).abs().max()) for a, b in zip(g_card, g_cpu))
    scale = max(float(b.abs().max()) for b in g_cpu)
    log(f"# {tag} train card fp32 vs CPU fp32 (2 rows): loss {loss_card!r} vs {loss_cpu!r}; "
        f"trunk and projection grads max_abs_err {err!r} of max |grad| {scale!r} (limits: loss "
        f"1e-4 relative, grads 1e-3 of max |grad|)")
    check(abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu), f"{tag}: card loss disagrees")
    check(err <= 1e-3 * scale, f"{tag}: card gradients disagree with the CPU")


def _bb_times(cfg: ProtSTonKGsConfig, engine, rows, state, card: str) -> dict:
    """(c) The embed's sequences/s and the step's median ms at the 128-wide
    path, then the pair at its shapes (B=8 eval plan, B=2 training plan
    forward and backward) beside bound, floor, plain version and SDPA over
    gathered operands.  Returns the kernels' numbers."""
    path = {"sequences_per_s": _prot_embed_rate(engine, rows),
            "step_ms": _prot_step_ms(cfg, state, protstonkgs.pretraining_loss)}
    log(f"# {cfg.trunk.hidden_size}-wide ProtSTonKGs path: {json.dumps(path)} ({card})")
    t = cfg.trunk
    gen = torch.Generator().manual_seed(27)
    geo = dict(S=cfg.seq_len, H=t.num_attention_heads, D=t.head_dim, r=t.num_random_blocks,
               bs=t.block_size)
    shape = f"S={cfg.seq_len} H={geo['H']} D={geo['D']} bs={geo['bs']} r={geo['r']}"
    result = {}
    for key, label, B, backward, plan in (
            ("bigbird_mid_fwd", f"serving B={BB_EMBED_BATCH} {shape} eval plan", BB_EMBED_BATCH,
             False, "eval"),
            ("bigbird_mid_fwd:train", f"training B={BB_BATCH} {shape} train plan", BB_BATCH,
             False, "train"),
            ("bigbird_mid_bwd", f"training B={BB_BATCH} {shape} train plan", BB_BATCH, True,
             "train")):
        result[key] = _time_sparse(label, B, gen, backward, plan, **geo)
        log(f"# time {key.split(':')[0]} {label} bf16 ({card}): {json.dumps(result[key])}")
    result["path"] = path
    return result


def _bb_any_paths(tmp: str, card: str) -> tuple:
    """(d) The stores of ``BB_ANY_PATHS`` through ``_bb_path`` at
    BB_ANY_STEPS steps, each with its own TSV; the S = 200 store's (block
    25) counts and times (``_bb_times``).  Returns (the counts of every
    run, summed; the block-25 store's counts; its times)."""
    t0 = time.perf_counter()
    total: dict = {}
    counts25: dict = {}
    times25 = None
    for width, layout in BB_ANY_PATHS:
        art = make_random_artifacts(BB_KG_NODES, dim=width, rw_len=README_RW_LEN, seed=width)
        emb = os.path.join(tmp, f"emb_any{width}.tsv")
        save_kg_artifacts(art, emb, os.path.join(tmp, f"walks_any{width}.tsv"))
        counted: dict = {}
        cfg, state, engine, rows = _bb_path(width, layout, emb, tmp, counted, BB_ANY_STEPS)
        _add_counts(total, counted)
        if cfg.trunk.block_size == BB_DROP_FAULT:
            counts25 = counted
            times25 = _bb_times(cfg, engine, rows, state, card)
        del state, engine
        torch.cuda.empty_cache()
        log(f"# bigbird widths (d) S={sum(layout)} block {cfg.trunk.block_size}: "
            f"{time.perf_counter() - t0:.1f} s")
    return total, counts25, times25


def _bb_heads128(pcfg: ProtSTonKGsConfig, pparams: dict, card: str) -> tuple:
    """(e) ProtSTonKGs at its published widths with the trunk's 768 in
    BB_HEADS_128 heads of D = 128 on phase 11's parameters (the head split
    changes no parameter's shape): ``embed`` over BB_HEADS_ROWS rows at
    B=8 (launch counts from 0, finite output), phase 12's ``pretrain``
    (B=2, 4 steps), every forward of both on bigbird_fwd_wide_sm90_kernel
    (the library's count of its calls), phase 13's card fp32 against CPU
    fp32 numerics at this head split, then the pair's times at the trunk's
    shape (``_bb_times``).  Returns (the counts of the embed and the steps; the
    times)."""
    t0 = time.perf_counter()
    cfg = pcfg.replace(trunk=dataclasses.replace(pcfg.trunk, num_attention_heads=BB_HEADS_128))
    check(cfg.trunk.head_dim == 128 and bigbird_sparse_ops.bigbird_kernel_takes(
        cfg.trunk.block_size, cfg.trunk.head_dim, cfg.seq_len), f"the 6-head trunk: {cfg.trunk}")
    engine = ProtSTonKGsEngine(cfg=cfg, params=params_to(pparams, DEV, BF16),
                               batch_size=BB_EMBED_BATCH, device=DEV)
    rows = _prot_features(cfg, BB_HEADS_ROWS, seed=22)
    wide0 = bigbird_sparse_ops.wide_forward_calls()
    _, counts = _prot_embed_counted(f"ProtSTonKGs embed, trunk {BB_HEADS_128} x 128", engine,
                                    rows)
    train_counts, state, _ = phase_prot_training(cfg, pparams)
    _add_counts(counts, train_counts)
    # every bf16 forward at D = 128 runs bigbird_fwd_wide_sm90_kernel
    ran = bigbird_sparse_ops.wide_forward_calls() - wide0
    log(f"# check 6-head ProtSTonKGs embed and step route: {ran} calls of "
        f"bigbird_fwd_wide_sm90_kernel, {counts['bigbird_mid_fwd']} launches of bigbird_mid_fwd "
        f"{'ok' if ran == counts['bigbird_mid_fwd'] > 0 else 'FAIL'}")
    check(ran == counts["bigbird_mid_fwd"] > 0,
          "the 6-head ProtSTonKGs path did not run bigbird_fwd_wide_sm90_kernel at every call")
    phase_prot_train_numerics(cfg)
    log(f"# bigbird widths (e) 6 heads of 128: {time.perf_counter() - t0:.1f} s")
    times = _bb_times(cfg, engine, rows, state, card)
    del engine, state
    torch.cuda.empty_cache()
    return counts, times


def phase_bigbird_widths(card: str, pcfg: ProtSTonKGsConfig, pparams: dict) -> tuple:
    """Phase 27: (a) the pair at D = 16 and 32 and every block size the
    command line derives (any block size since the block rule went), the
    planted faults and the refused geometries, (b) ProtSTonKGs from
    synthetic node2vec TSVs (``BB_PATHS``), (c) times, (d) the stores
    past the old block rule (``BB_ANY_PATHS``: blocks 25, 4 and 2,048),
    (e) ProtSTonKGs in 6 heads of D = 128 on phase 11's ``pparams``.
    Returns (the launch counts of every counted run, summed; per kernel,
    the worst bf16 error at the new geometries; per kernel, the 128-wide
    path shape's times; the block-25 store's counts and times; the
    6-head path's counts and times)."""
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(27)
    errs: dict = {}

    def note(name, err, dtype):
        if dtype == BF16:
            errs[name] = max(errs.get(name, 0.0), err)

    _bb_kernels(gen, note)
    log(f"# bigbird widths (a) kernels: {time.perf_counter() - t_phase:.1f} s")
    total, times = {}, None
    with tempfile.TemporaryDirectory(prefix="stonkgs_bb_") as tmp:
        tsvs = {}
        for width in sorted({w for w, _ in BB_PATHS}):
            art = make_random_artifacts(BB_KG_NODES, dim=width, rw_len=README_RW_LEN, seed=width)
            tsvs[width] = os.path.join(tmp, f"emb{width}.tsv")
            save_kg_artifacts(art, tsvs[width], os.path.join(tmp, f"walks{width}.tsv"))
        log(f"# bigbird widths: node2vec TSVs of {BB_KG_NODES} nodes at widths {sorted(tsvs)}: "
            f"{time.perf_counter() - t_phase:.1f} s")
        for i, (width, layout) in enumerate(BB_PATHS):
            cfg, state, engine, rows = _bb_path(width, layout, tsvs[width], tmp, total)
            if i == 0:
                times = _bb_times(cfg, engine, rows, state, card)
            del state, engine
            torch.cuda.empty_cache()
        log(f"# bigbird widths (b, c): {time.perf_counter() - t_phase:.1f} s")
        any_total, counts25, times25 = _bb_any_paths(tmp, card)
        _add_counts(total, any_total)
    counts128, times128 = _bb_heads128(pcfg, pparams, card)
    _add_counts(total, counts128)
    log(f"# bigbird widths phase: {time.perf_counter() - t_phase:.1f} s")
    return total, errs, times, (counts25, times25), (counts128, times128)


# ---------------------------------------------------------------------------
# phase 28: the attention kernels at every head width up to 128; STonKGs at
# BERT-base's widths with 6 heads of D=128, and the CLI's 96-, 160-, 288-
# and 544-wide configs
# ---------------------------------------------------------------------------

# head widths of the attention checks: below 8 (1, 2 and the CLI's 4- and
# 8-wide configs' 2 and 4, 7; padded to 8, run at 16), 8, widths inside
# each padded instance (24, 48, 96, 112), the CLI's derived 48, 68 (a
# 136-byte bf16 row, which the wrappers pad to 72 for TMA), 72 and 80, and
# 128
HEAD_WIDTHS = (1, 2, 4, 7, 8, 24, 48, 68, 72, 80, 96, 112, 128)
HEAD_S = (1, 65, 512)
HEAD_BATCH, HEAD_HEADS = 2, 3
# the planted faults' widths: both reach the second 64-column block
HEAD_FAULT_DIMS = (80, 128)
# (S, D) outside the attention kernels' domain (phase 26 (a) refuses them):
# no head width, no rows
HEAD_OUTSIDE = ((64, 0), (0, 32))
# head widths the C entry points refuse (they take positive multiples of 8)
WIDTHS_C_OUTSIDE = (0, 4, 36, 68)
# STonKGs at BERT-base's widths (12 x 768, I=3072, 256 + 256, KG vocabulary
# 100,000) with its 768 split into 6 heads of D=128
HEADS_128 = 6
# the KG TSV widths whose derived configs run at D = 48, 80, 72 and 68
HEAD_TSV_WIDTHS = (96, 160, 288, 544)
HEAD_KERNELS = ("flash_attention_infer", "flash_attention_train_fwd",
                "flash_attention_train_bwd")


def _heads_attention(gen, note) -> None:
    """(a) The three attention kernels at every D of HEAD_WIDTHS against
    their plain versions, bf16 and fp32, at S = 1, 65 and 512, B=2 with 3
    heads: inference with the key bias (batch row 0's keys all at -1e9)
    and without it, the training forward at rates 0 and 0.1 (output and
    lse), and the backward at both rates (``_attention_bwd_cases``: with
    and without db, unmasked, a row all at -1e9; at S=512 in bf16 its
    limits must reject dK without its scale and dV without the keep
    scale).  At D = 80 and 128 (``HEAD_FAULT_DIMS``), S=512, in bf16 the
    output limit must reject the plain output without the scores' columns
    from 64 on (a lost second column block) and, at rate 0.1, under
    another seed's mask."""
    B, H = HEAD_BATCH, HEAD_HEADS
    for dtype in (BF16, F32):
        tag = "bf16" if dtype == BF16 else "fp32"
        for D in HEAD_WIDTHS:
            for S in HEAD_S:
                label = f"{tag} D={D} B={B} H={H} S={S}"
                faults = dtype == BF16 and S == HEAD_S[-1] and D in HEAD_FAULT_DIMS
                q, k, v, bias, _, seed, _ = _train_attn_inputs(B, S, dtype, gen, True, H, D)
                bias[0] = -1e9
                for b_label, b in (("mask row 0 all -1e9", bias), ("no-bias", None)):
                    want = flash_attention_infer_plain(q, k, v, b)
                    e = _compare_attn(f"attention {label} {b_label}",
                                      flash_attention_infer(q, k, v, b), want, dtype)
                    note("flash_attention_infer", e, dtype)
                if faults:
                    cut_q, cut_k = q.clone(), k.clone()
                    cut_q[..., 64:] = 0
                    cut_k[..., 64:] = 0
                    _attn_limit_rejects(f"attention {label} no-bias without the scores' columns "
                                        f"64-{D - 1}", want,
                                        flash_attention_infer_plain(cut_q, cut_k, v))
                for rate in (0.0, ATTN_RATE):
                    out, lse = flash_attention_train_fwd(q, k, v, bias, seed, rate)
                    out_p, lse_p = flash_attention_train_fwd_plain(q, k, v, bias, seed, rate)
                    e = max(_compare_attn(f"attention fwd {label} rate={rate}", out, out_p,
                                          dtype),
                            _compare(f"attention lse {label} rate={rate}", lse, lse_p, F32))
                    note("flash_attention_train_fwd", e, dtype)
                    if faults and rate > 0:
                        other = (seed + 1).to(torch.int32)
                        _attn_limit_rejects(
                            f"attention fwd {label} rate={rate} with another seed's mask",
                            out_p, flash_attention_train_fwd_plain(q, k, v, bias, other, rate)[0])
                    e = _attention_bwd_cases(tag, dtype, B, H, S, rate, gen, D)
                    note("flash_attention_train_bwd", e, dtype)
                del q, k, v, bias


def _heads_cfg() -> STonKGsConfig:
    return STonKGsConfig(bert=BertConfig(num_attention_heads=HEADS_128), kg_vocab_size=100_000)


def _heads_serving(cfg: STonKGsConfig, params: dict) -> dict:
    """(b) ``STonKGsEngine.embed`` at BERT-base's widths with 6 heads of
    D=128 (3 of D=256 and 2 of D=384 in phase 29) on phase 5's parameters
    (the head split changes no shape): ROWS rows at B=128 in parity mode in
    bf16, the serving kernels' launches from 0 just before it, finite
    output, pairs/s over 3 more runs (as phase 6 times phase 5's engine);
    then 4 rows on the card in fp32 against the CPU in fp32 (1e-3) and the
    bf16 rows against the CPU by cosine (0.99), as phase 5.  Returns the
    launch counts."""
    t0 = time.perf_counter()
    tag = f"D={cfg.bert.head_dim}"
    feats = _features(cfg, ROWS, seed=28)
    engine = STonKGsEngine(cfg=cfg, params=params_to(params, DEV, BF16), batch_size=BATCH,
                           device=DEV)
    _reset_counts(SERVING_KERNELS)
    torch.cuda.synchronize()
    out = engine.embed(feats)
    counts = _counts(SERVING_KERNELS)
    per_batch = cfg.bert.num_hidden_layers * 2 - 1
    _check_counts(f"{tag} parity embed ({math.ceil(ROWS / BATCH)} batches)", counts,
                  {n: per_batch * math.ceil(ROWS / BATCH) for n in SERVING_KERNELS})
    check(out.shape == (ROWS, cfg.bert.hidden_size) and bool(np.isfinite(out).all()),
          f"{tag} embed output {out.shape} not finite")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        engine.embed(feats)
        times.append(time.perf_counter() - t1)
    log(f"# embed {tag} parity: {ROWS} rows, B={BATCH}, seconds {times!r}; best "
        f"{ROWS / min(times)!r} pairs/s, median {ROWS / statistics.median(times)!r} pairs/s")
    del engine
    few = {k: v[:4] for k, v in feats.items()}
    card32 = STonKGsEngine(cfg=cfg, params=params, compute_dtype="float32", batch_size=4,
                           device=DEV).embed(few)
    cpu32 = STonKGsEngine(cfg=cfg, params=params, compute_dtype="float32", batch_size=4,
                          device="cpu").embed(few)
    err32 = float(np.abs(card32 - cpu32).max())
    cos = _cosine(out[:4], cpu32)
    log(f"# {tag} embed: card fp32 vs CPU fp32 (4 rows) max_abs_err {err32!r} (limit 1e-3); "
        f"card bf16 vs CPU fp32 cosine {cos.tolist()!r} (limit 0.99); "
        f"{time.perf_counter() - t0:.1f} s")
    check(err32 <= 1e-3, f"{tag}: card fp32 embeddings disagree with the CPU")
    check(bool((cos >= 0.99).all()), f"{tag}: card bf16 embeddings too far from the CPU")
    return counts


def _attn_floor_ms(B: int, H: int, S: int, D: int, products: int) -> float:
    """The two-pass design's floor: ``products`` products of 2·B·H·S²·D
    flops at the bf16 peak, or two exps a score at the SFU's rate,
    whichever is longer."""
    return max(products * 2.0 * B * H * S * S * D / PEAK_FLOPS[BF16],
               2.0 * B * H * S * S / EX2_PER_S) * 1e3


def _heads_times(cfg: STonKGsConfig, card: str) -> dict:
    """(d) The three kernels at (b)'s shapes (6 heads of D=128) beside
    their bound, the design's floor (three products and two exps a score
    forward, seven products backward), their plain versions and SDPA (the
    backward: SDPA's alone over a saved forward, with the backend that
    ran): inference at B=128 over the trunk (S=512, masked) and the
    backbone (S=256, no bias), the training forward at B=32 over both,
    the backward over the trunk.  Returns, per kernel, the trunk shape's
    numbers with the worse error of its shapes."""
    gen = torch.Generator(device=DEV).manual_seed(28)
    nh, D = cfg.bert.num_attention_heads, cfg.bert.head_dim
    sl, tl, B = cfg.seq_len, cfg.text_len, TRAIN_BATCH
    cases = {
        "flash_attention_infer": [
            (f"D={D} trunk B={BATCH} S={sl} mask", BATCH, sl, 3,
             lambda lb: _time_attention(lb, BATCH, sl, True, gen, nh, D)),
            (f"D={D} backbone B={BATCH} S={tl} no-bias", BATCH, tl, 3,
             lambda lb: _time_attention(lb, BATCH, tl, False, gen, nh, D))],
        "flash_attention_train_fwd": [
            (f"D={D} trunk B={B} S={sl} mask", B, sl, 3,
             lambda lb: _time_train_attention(lb, B, sl, True, gen, False, nh, D)),
            (f"D={D} backbone B={B} S={tl} no-bias", B, tl, 3,
             lambda lb: _time_train_attention(lb, B, tl, False, gen, False, nh, D))],
        "flash_attention_train_bwd": [
            (f"D={D} trunk B={B} S={sl} mask", B, sl, 7,
             lambda lb: _time_train_attention(lb, B, sl, True, gen, True, nh, D))],
    }
    result = {}
    for name, shapes in cases.items():
        for i, (label, b, S, products, fn) in enumerate(shapes):
            t = fn(label)
            t["floor_ms"] = _attn_floor_ms(b, nh, S, D, products)
            log(f"# time {name} {label} bf16 ({card}): {json.dumps(t)}")
            if i == 0:
                result[name] = t
            else:
                result[name]["max_abs_err"] = max(result[name]["max_abs_err"],
                                                  t["max_abs_err"])
    return result


def phase_head_widths(card: str, params: dict) -> tuple:
    """Phase 28: (a) the attention kernels at every head width of
    HEAD_WIDTHS against their plain versions (the refused widths are
    phase 26's), (b) STonKGs at BERT-base's widths with 6 heads of D=128
    on phase 5's parameters: ``embed`` and phase 7's ``pretrain`` (B=32, 4
    steps) and phase 8's numerics, (c) ``run_pretraining`` -> ``embed``
    from 96-, 160-, 288- and 544-wide KG TSVs (D = 48, 80, 72, 68), (d)
    times.  Returns (the launch counts of every counted run, summed; the
    counts of the D=128 embed and step; per kernel, the worst bf16 error
    of (a); per kernel, the D=128 shapes' times)."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(28)
    errs: dict = {}

    def note(name, err, dtype):
        if dtype == BF16:
            errs[name] = max(errs.get(name, 0.0), err)

    _heads_attention(gen, note)
    log(f"# head widths (a) kernels: {time.perf_counter() - t_phase:.1f} s")
    cfg = _heads_cfg()
    counts = _heads_serving(cfg, params)
    train_counts, state = phase_training(cfg, params)
    counts.update(train_counts)
    del state
    phase_train_numerics(cfg)
    log(f"# head widths (b) D=128: {time.perf_counter() - t_phase:.1f} s")
    total = dict(counts)
    for hidden in HEAD_TSV_WIDTHS:
        _widths_pretrain_files(hidden, total, entities=WIDE_ENTITIES)
    log(f"# head widths (c) the CLI's configs: {time.perf_counter() - t_phase:.1f} s")
    times = _heads_times(cfg, card)
    torch.cuda.empty_cache()
    log(f"# head widths phase: {time.perf_counter() - t_phase:.1f} s")
    return total, counts, errs, times


# ---------------------------------------------------------------------------
# phase 29: the FFN kernels at every hidden width from 8 to 2048 and the
# BigBird pair at every head width from 8 to 64; STonKGs and ProtSTonKGs
# from KG TSVs 48 to 1280 wide
# ---------------------------------------------------------------------------

# hidden widths of the FFN checks: below 32 (16), no multiple of 32 (48,
# 112, 144), no multiple of 8 (100, padded in both dtypes' layouts), above
# 1024 (1056, 1280: the fp32 bodies' wide instance) and the widest (2048);
# each at I = 4H (0 here), 100 and 1000
WIDE_FFN_H = (16, 48, 100, 112, 144, 1056, 1280, 2048)
WIDE_FFN_I = (0, 100, 1000)
WIDE_FFN_M = (3, 200)
# the planted faults' width (padded to 104 in bf16, 128 in fp32) and the
# output columns of one TMA store box, the last partial one at H=100
WIDE_FAULT_H = 100
WIDE_FAULT_COLS = 64
# the FFN widths outside the kernels' domain (H or I 0)
WIDE_FFN_OUTSIDE = ((0, 16), (16, 0))
# the BigBird checks' head widths (36: a 72-byte bf16 row, padded to 40),
# each at (block size, B, H, nb, padded mask): block 64 (the padded
# instances' run-time block of one tile) and 96 (a partial tile, nb = 5)
WIDE_BB_D = (8, 24, 36, 40, 48, 56)
WIDE_BB_GEOS = ((64, 2, 3, 8, True), (96, 2, 2, 5, False))
# the planted fault's head width and the padded instance's width
WIDE_BB_FAULT = (24, 32)
# past the old head rule (8 to 64): D = 1, 2, 4 and 7 (padded to 8) and
# the SIMT bodies' column parts from 72 to 520, each at block 64, 25 (a
# partial tile) and 512 (nb = 5, one batch row)
WIDE_BB_ANY_D = (1, 2, 4, 7, 72, 100, 128, 200, 256, 384, 520)
WIDE_BB_ANY_GEOS = ((64, 2, 3, 8, True), (25, 2, 2, 8, True), (512, 1, 2, 5, False))
# the planted fault: at D = 128 the logits without their columns from 64 on
WIDE_BB_COL_FAULT = (128, 64)
# the planted fault of the forward past D = 128: at D = 384 each row's
# statistics without the last column block (320 on)
WIDE_BB_STATS_FAULT = (384, 320)
# STonKGs from these KG TSV widths: 2 heads of 24, 40, 50 and 56, 20 of 64
# (H = 1280, I = 5120); TransE from the 80-wide one; the rows of their
# TSVs (phase 26's 5,000 made the 1280-wide path 24 s, two thirds of it
# writing and reading the TSV and the checkpoint)
WIDE_TSV_WIDTHS = (48, 80, 100, 112, 1280)
# ... and from 8- and 4-wide ones (2 heads of 4; H = 4 in 2 heads of 2)
WIDE_NARROW_TSV_WIDTHS = (8, 4)
WIDE_TRANSE_WIDTH = 80
WIDE_ENTITIES = 1000
# ProtSTonKGs from these (width, text | entity | protein lengths): trunk
# heads of 24, 40, 36 (and the backbones'), blocks 96 and 512 (phase 27's)
WIDE_PROT_PATHS = ((48, (384, 128, 256)), (80, (768, 256, 3072)), (144, (384, 128, 256)))


def _ffn_ln_padded_stats(args, Hp, act):
    """The serving block's plain version with a known fault: both
    LayerNorms' statistics taken over the padded width ``Hp`` (the zero
    columns counted) instead of the true H."""
    x, attn, g1, be1, w1, b1, w2, b2, g2, be2 = args
    dt, f, H = x.dtype, torch.float32, x.shape[-1]

    def ln(y, g, b):
        pad = lambda t: F.pad(t.float(), (0, Hp - H))  # noqa: E731
        return fused_ffn_ops._layer_norm_rows(pad(y), pad(g), pad(b), 1e-12)[..., :H]

    x2 = ln(x.float() + attn.float(), g1, be1).to(dt)
    h = fused_ffn_ops._gelu(x2.float() @ w1.to(dt).float() + b1.float(), act).to(dt)
    ff = (h.float() @ w2.to(dt).float() + b2.float()).to(dt)
    return ln(x2.float() + ff.float(), g2, be2).to(dt)


def _wide_ffn(gen, note) -> None:
    """(a) The three FFN kernels at every H of WIDE_FFN_H with I = 4H, 100
    and 1000, M = 3 and 200, gelu (and gelu_new at I = 4H, M = 200), bf16
    and fp32, against their plain versions (weights at 1/sqrt(fan-in)).
    At H=100, I=400, M=200 the limits must reject, in both dtypes, the
    plain serving block with its LayerNorm statistics over the padded
    width (104 in bf16, 128 in fp32), and the plain serving block and
    training forward with the W2 product's last partial tile of 64 output
    columns lost (columns 64-99 left at b2)."""
    for dtype in (BF16, F32):
        tag = "bf16" if dtype == BF16 else "fp32"
        for H in WIDE_FFN_H:
            for i_ in WIDE_FFN_I:
                I = i_ or 4 * H
                for M in WIDE_FFN_M:
                    big = i_ == 0 and M == WIDE_FFN_M[-1]
                    for act in ("gelu", "gelu_new") if big else ("gelu",):
                        label = f"{tag} H={H} I={I} M={M} {act}"
                        faults = big and H == WIDE_FAULT_H and act == "gelu"
                        args = _ffn_inputs(M, dtype, gen, H, I, fan_in=True)
                        want = fused_ffn_ln_block_plain(*args, act=act)
                        e = _compare(f"ffn_ln {label}", fused_ffn_ln_block(*args, act=act), want,
                                     dtype)
                        note("ffn_ln_block", e, dtype)
                        cut = WIDE_FAULT_COLS * (H // WIDE_FAULT_COLS)
                        if faults:
                            Hp = fused_ffn_ops.padded_width(H, dtype)
                            _tol_rejects(f"ffn_ln {label} with the LayerNorm statistics over "
                                         f"the padded width {Hp}", want,
                                         _ffn_ln_padded_stats(args, Hp, act))
                            w2 = args[6].clone()
                            w2[:, cut:] = 0
                            _tol_rejects(f"ffn_ln {label} without the W2 product's columns "
                                         f"{cut}-{H - 1}", want, fused_ffn_ln_block_plain(
                                             *args[:6], w2, *args[7:], act=act))
                        x, w1, b1, w2, b2, g = _train_ffn_inputs(M, dtype, gen, H, I,
                                                                 fan_in=True)
                        want = fused_ffn_plain(x, w1, b1, w2, b2, act=act)
                        e = _compare(f"ffn fwd {label}",
                                     fused_ffn_fwd(x, w1, b1, w2, b2, act=act), want, dtype)
                        note("ffn_train_fwd", e, dtype)
                        if faults:
                            w2c = w2.clone()
                            w2c[:, cut:] = 0
                            _tol_rejects(f"ffn fwd {label} without the W2 product's columns "
                                         f"{cut}-{H - 1}", want,
                                         fused_ffn_plain(x, w1, b1, w2c, b2, act=act))
                        got = fused_ffn_bwd(x, g, w1, b1, w2, act=act)
                        want = fused_ffn_bwd_plain(x, g, w1, b1, w2, act=act)
                        e = max(_compare_rel(f"ffn dx {label}", got[0], want[0], dtype),
                                _compare_rel(f"ffn dh {label}", got[1], want[1], dtype),
                                _compare(f"ffn a {label}", got[2], want[2], dtype))
                        note("ffn_train_bwd", e, dtype)
                        del args, x, w1, b1, w2, b2, g, got, want


def _wide_bigbird(gen, note) -> None:
    """(b) The BigBird pair at every head width of WIDE_BB_D and each
    geometry of WIDE_BB_GEOS against its plain versions (``_bb_cases``);
    then at D=24 in bf16 (block 64, the training plan, integer-valued q
    and k, where the rounded Q·Kᵀ is exact) the kernel within the limits
    and the plain output at the padded instance's scale 1/sqrt(32) (in
    place of 1/sqrt(24)) rejected by them; the pair at WIDE_BB_ANY_D (the
    bf16 forward past D = 64 on bigbird_fwd_wide_sm90_kernel, its route
    read from the library's count), and the limits rejecting the plain
    output without the logits' columns from 64 on at D = 128
    (WIDE_BB_COL_FAULT) and with each row's statistics without the last
    column block at D = 384 (WIDE_BB_STATS_FAULT)."""
    _bb_cases([(bs, D, B, H, nb, padded) for D in WIDE_BB_D
               for bs, B, H, nb, padded in WIDE_BB_GEOS], gen, note)
    D, P = WIDE_BB_FAULT
    label = f"bf16 D={D} bs=64 train plan"
    _, _, _, mask, rand, _ = _sparse_inputs(2, 8, BF16, gen, "train", False, 3, 64, D, BB_R)
    q, k, v = _integer_qkv(2, 8 * 64, 3, D, gen)
    want = bigbird_mid_fwd_plain(q, k, v, mask, rand, 64)[0]
    e = _compare_attn(f"sparse fwd {label} integer q, k",
                      bigbird_mid_fwd(q, k, v, mask, rand, 64)[0], want, BF16)
    note("bigbird_mid_fwd", e, BF16)
    _attn_limit_rejects(f"sparse fwd {label} integer q, k at the scale 1/sqrt({P})", want,
                        _sparse_fwd_fault(q, k, v, mask, rand, 64, scale_d=P))
    _bb_cases([(bs, D, B, H, nb, padded) for D in WIDE_BB_ANY_D
               for bs, B, H, nb, padded in WIDE_BB_ANY_GEOS], gen, note)
    D, c = WIDE_BB_COL_FAULT
    q, k, v, mask, rand, _ = _sparse_inputs(2, 8, BF16, gen, "train", True, 3, 64, D, BB_R)
    cut_q, cut_k = q.clone(), k.clone()
    cut_q[..., c:] = 0
    cut_k[..., c:] = 0
    _attn_limit_rejects(f"sparse fwd bf16 D={D} bs=64 train plan without the logits' columns "
                        f"{c}-{D - 1}", bigbird_mid_fwd_plain(q, k, v, mask, rand, 64)[0],
                        bigbird_mid_fwd_plain(cut_q, cut_k, v, mask, rand, 64)[0])
    D, c = WIDE_BB_STATS_FAULT
    q, k, v, mask, rand, _ = _sparse_inputs(2, 8, BF16, gen, "train", True, 3, 64, D, BB_R)
    _attn_limit_rejects(f"sparse fwd bf16 D={D} bs=64 train plan with each row's statistics "
                        f"over the logits without their columns {c}-{D - 1}",
                        bigbird_mid_fwd_plain(q, k, v, mask, rand, 64)[0],
                        _sparse_fwd_stats_cut(q, k, v, mask, rand, 64, c))


def _sparse_fwd_stats_cut(q, k, v, mask, rand, bs, c):
    """The plain forward with a known fault: each row's softmax statistics
    (m, l) taken over the logits without the columns of q and k from ``c``
    on (a statistics pass that drops its last column block), its
    probabilities exp(s - m) / l over the whole logits."""
    B, S, H, D = q.shape
    f = torch.float32
    qm, kc, vc, pen, _ = _mid_operands(q, k, v, mask, rand, bs)
    cut = qm.clone()
    cut[..., c:] = 0
    partial = _mid_logits(cut, kc, pen, q.dtype)
    m = partial.amax(dim=-1, keepdim=True)
    l = torch.exp(partial - m).sum(dim=-1, keepdim=True)
    w = (torch.exp(_mid_logits(qm, kc, pen, q.dtype) - m) / l).to(q.dtype)
    ctx = torch.einsum("bhjqk,bhjkd->bhjqd", w.to(f), vc.to(f)).to(q.dtype)
    return ctx.permute(0, 2, 3, 1, 4).reshape(B, -1, H, D)


def _wide_paths(total: dict) -> dict:
    """(c) STonKGs ``run_pretraining`` -> ``from_pretrained`` -> ``embed``
    from each width of WIDE_TSV_WIDTHS and WIDE_NARROW_TSV_WIDTHS and
    TransE from the 80-wide TSV (``_widths_pretrain_files``, WIDE_ENTITIES
    rows), and ProtSTonKGs from each TSV of WIDE_PROT_PATHS (``_bb_path``):
    launch counts from 0, card fp32 against CPU fp32, card bf16 by cosine.
    Returns the 4-wide path's counts."""
    for hidden in WIDE_TSV_WIDTHS:
        _widths_pretrain_files(hidden, total, entities=WIDE_ENTITIES)
    narrow: dict = {}
    for hidden in WIDE_NARROW_TSV_WIDTHS:
        counted: dict = {}
        _widths_pretrain_files(hidden, counted, entities=WIDE_ENTITIES)
        _add_counts(total, counted)
        narrow[hidden] = counted
    _widths_pretrain_files(WIDE_TRANSE_WIDTH, total, variant="transe", entities=WIDE_ENTITIES)
    with tempfile.TemporaryDirectory(prefix="stonkgs_wide_") as tmp:
        for width, layout in WIDE_PROT_PATHS:
            art = make_random_artifacts(BB_KG_NODES, dim=width, rw_len=README_RW_LEN, seed=width)
            emb = os.path.join(tmp, f"emb{width}.tsv")
            save_kg_artifacts(art, emb, os.path.join(tmp, f"walks{width}.tsv"))
            _bb_path(width, layout, emb, tmp, total)
            torch.cuda.empty_cache()
    return narrow[min(WIDE_NARROW_TSV_WIDTHS)]


# the widths past the earlier domains (phase 29 (d)-(g)): the FFN at (H, I)
# just past the old cap of 2048 (2056, no multiple of 32), the CLI's
# 2560-wide config (Megatron-BERT 3.9B's H and I), 4096 and 8192 at I = 4H,
# and I past the old cap of 8192 at H = 768
WIDEST_FFN = ((2056, 8224), (2560, 10240), (4096, 16384), (8192, 32768), (768, 8200))
WIDEST_FFN_M = (3, 200)
# the planted fault: the LayerNorm statistics over the first 2048 columns
# (a register row's width) at H = 2560
WIDEST_LN_FAULT = (2560, 2048)
# head widths past 128: 136 (just past), 140 (no multiple of 8: padded to
# 144), 160, 192, 200 and 256 (3 heads at BERT-base's 768), all run at P = 256
WIDEST_HEAD_DIMS = (136, 140, 160, 192, 200, 256)
# past the old cap of 256, run in bf16 by attn_fwd_wide_sm90_kernel (the
# forward, O in column parts of 128) and otherwise by the kernels of a warp
# a row in column parts of 256: 264 (just past), 300 (no multiple of 8:
# padded to 304), 384 (2 heads at BERT-base's 768; Q stays in shared
# memory), 768 (1 head; Q's column blocks streamed beside K's), 1,024 and
# 2,560 (40 column blocks, 20 parts of 128)
WIDEST_ANY_HEAD_DIMS = (264, 300, 384, 768, 1024, 2560)
# the planted faults: the scores without their columns from 128 on at D =
# 256, from 256 on (the second column part's of a warp a row) at D = 384,
# and from 2,048 on (the last streamed column blocks of Q and K) at 2,560
WIDEST_HEAD_FAULTS = ((256, 128), (384, 256), (2560, 2048))
# the FFN below 8: the CLI's 4-wide config (I = 16), and H or I from 2 to 6
TINY_FFN = ((4, 16), (6, 24), (2, 8), (16, 4))
# the planted fault: at H = 4 the LayerNorm statistics over 8 columns (the
# padded bf16 row)
TINY_LN_FAULT = (4, 8)
HEADS_384 = 2
# STonKGs from a 2560-wide KG TSV: WIDEST_ENTITIES rows, 4 steps of B=32,
# embed over one batch of B=128 (ROWS until the smoke's time was won back
# for the last widths); and BERT-base's widths in 3 heads of 256
WIDEST_TSV_WIDTH = 2560
WIDEST_ENTITIES = 1000
WIDEST_PF_STEPS = 4
HEADS_256 = 3


def _ffn_ln_first_stats(args, n: int, act):
    """The serving block's plain version with a known fault: both
    LayerNorms' statistics taken over the first ``n`` columns only (one
    chunk of a wide row), applied to all of H."""
    x, attn, g1, be1, w1, b1, w2, b2, g2, be2 = args
    dt = x.dtype

    def ln(y, g, b):
        m = y[..., :n].mean(dim=-1, keepdim=True)
        v = (y[..., :n] - m).square().mean(dim=-1, keepdim=True)
        return (y - m) * torch.rsqrt(v + 1e-12) * g.float() + b.float()

    x2 = ln(x.float() + attn.float(), g1, be1).to(dt)
    h = fused_ffn_ops._gelu(x2.float() @ w1.to(dt).float() + b1.float(), act).to(dt)
    ff = (h.float() @ w2.to(dt).float() + b2.float()).to(dt)
    return ln(x2.float() + ff.float(), g2, be2).to(dt)


def _widest_ffn(gen, note, pairs=WIDEST_FFN, fault=None) -> None:
    """(d) The three FFN kernels at every (H, I) of ``pairs`` (WIDEST_FFN;
    (h) TINY_FFN, H or I below 8), M = 3 and 200, gelu (and gelu_new at M =
    200), bf16 and fp32, against their plain versions (weights at
    1/sqrt(fan-in), drawn on the card): bf16 above H = 2048 through the
    chunked LayerNorm pass, fp32 through the split path.  At ``fault``'s
    (H, fault function) (WIDEST_FFN: H = 2560 with the LayerNorm
    statistics over the first 2048 columns; TINY_FFN: H = 4 with them over
    8, the padded bf16 row), M = 200, gelu, the limits must reject the
    faulty plain serving block in both dtypes."""
    fault_h, fault_label, faulty = fault or (
        WIDEST_LN_FAULT[0], f"over the first {WIDEST_LN_FAULT[1]} columns",
        lambda args, act: _ffn_ln_first_stats(args, WIDEST_LN_FAULT[1], act))
    for dtype in (BF16, F32):
        tag = "bf16" if dtype == BF16 else "fp32"
        for H, I in pairs:
            for M in WIDEST_FFN_M:
                big = M == WIDEST_FFN_M[-1]
                for act in ("gelu", "gelu_new") if big else ("gelu",):
                    label = f"{tag} H={H} I={I} M={M} {act}"
                    args = _ffn_inputs(M, dtype, gen, H, I, fan_in=True)
                    want = fused_ffn_ln_block_plain(*args, act=act)
                    e = _compare(f"ffn_ln {label}", fused_ffn_ln_block(*args, act=act), want,
                                 dtype)
                    note("ffn_ln_block", e, dtype)
                    if big and act == "gelu" and H == fault_h:
                        _tol_rejects(f"ffn_ln {label} with the LayerNorm statistics "
                                     f"{fault_label}", want, faulty(args, act))
                    del args, want
                    x, w1, b1, w2, b2, g = _train_ffn_inputs(M, dtype, gen, H, I, fan_in=True)
                    e = _compare(f"ffn fwd {label}", fused_ffn_fwd(x, w1, b1, w2, b2, act=act),
                                 fused_ffn_plain(x, w1, b1, w2, b2, act=act), dtype)
                    note("ffn_train_fwd", e, dtype)
                    got = fused_ffn_bwd(x, g, w1, b1, w2, act=act)
                    want = fused_ffn_bwd_plain(x, g, w1, b1, w2, act=act)
                    e = max(_compare_rel(f"ffn dx {label}", got[0], want[0], dtype),
                            _compare_rel(f"ffn dh {label}", got[1], want[1], dtype),
                            _compare(f"ffn a {label}", got[2], want[2], dtype))
                    note("ffn_train_bwd", e, dtype)
                    del x, w1, b1, w2, b2, g, got, want
        torch.cuda.empty_cache()


def _tiny_ffn(gen, note) -> None:
    """(h) ``_widest_ffn`` at TINY_FFN, the LayerNorm fault at H = 4 over
    the 8 columns of the padded bf16 row (``_ffn_ln_padded_stats``)."""
    h, n = TINY_LN_FAULT
    _widest_ffn(gen, note, TINY_FFN,
                (h, f"over {n} columns", lambda args, act: _ffn_ln_padded_stats(args, n, act)))


def _widest_attention(gen, note, dims=WIDEST_HEAD_DIMS) -> None:
    """(e) The three attention kernels at every D of ``dims`` against
    their plain versions, bf16 and fp32, at S = 1, 65 and 512, B=2 with 3
    heads, as phase 28 (a): inference with the key bias (batch row 0's
    keys all at -1e9) and without it, the training forward at rates 0 and
    0.1 (output and lse), the backward at both rates
    (``_attention_bwd_cases``; at S=512 in bf16 its limits must reject dK
    without its scale and dV without the keep scale).  At each (D, c) of
    WIDEST_HEAD_FAULTS, S=512, in bf16 the output limit must reject the
    plain output without the scores' columns from c on (256: half of the
    wide row lost; 384: the second column part's; 2,560: the last eight
    streamed column blocks).  In bf16 past D = 256 (the Hopper instances'
    widest) each forward call must raise its library's count of calls that ran
    attn_fwd_wide_sm90_kernel by one (``_wide_route``; the forward of a warp
    a row is no longer on that route), and each backward call the count of
    the backward's dS pass and GEMMs (``_attention_bwd_cases``)."""
    B, H = HEAD_BATCH, HEAD_HEADS
    faults = dict(WIDEST_HEAD_FAULTS)
    for dtype in (BF16, F32):
        tag = "bf16" if dtype == BF16 else "fp32"
        for D in dims:
            for S in HEAD_S:
                label = f"{tag} D={D} B={B} H={H} S={S}"
                q, k, v, bias, _, seed, _ = _train_attn_inputs(B, S, dtype, gen, True, H, D)
                bias[0] = -1e9
                wide = dtype == BF16 and D > flash_attention_ops.MAX_INSTANCE_HEAD_DIM
                for b_label, b in (("mask row 0 all -1e9", bias), ("no-bias", None)):
                    want = flash_attention_infer_plain(q, k, v, b)
                    got = _wide_route(f"{label} {b_label}", "flash_attention_infer", wide,
                                      lambda: flash_attention_infer(q, k, v, b))
                    e = _compare_attn(f"attention {label} {b_label}", got, want, dtype)
                    note("flash_attention_infer", e, dtype)
                if dtype == BF16 and S == HEAD_S[-1] and D in faults:
                    fault_c = faults[D]
                    cut_q, cut_k = q.clone(), k.clone()
                    cut_q[..., fault_c:] = 0
                    cut_k[..., fault_c:] = 0
                    _attn_limit_rejects(f"attention {label} no-bias without the scores' columns "
                                        f"{fault_c}-{D - 1}", want,
                                        flash_attention_infer_plain(cut_q, cut_k, v))
                for rate in (0.0, ATTN_RATE):
                    out, lse = _wide_route(f"{label} rate={rate}", "flash_attention_train_fwd",
                                           wide, lambda: flash_attention_train_fwd(
                                               q, k, v, bias, seed, rate))
                    out_p, lse_p = flash_attention_train_fwd_plain(q, k, v, bias, seed, rate)
                    e = max(_compare_attn(f"attention fwd {label} rate={rate}", out, out_p,
                                          dtype),
                            _compare(f"attention lse {label} rate={rate}", lse, lse_p, F32))
                    note("flash_attention_train_fwd", e, dtype)
                    e = _attention_bwd_cases(tag, dtype, B, H, S, rate, gen, D)
                    note("flash_attention_train_bwd", e, dtype)
                del q, k, v, bias


# scratch caps of the backward past D = 256 and the plans they force at
# D = 384, S = 512, B = 2 with 3 heads: groups of two heads, then one head
# in chunks of 128 query rows (dK and dV carried in fp32)
WIDE_BWD_CAPS = ((4 * 512 * 512 * 2, (2, 512)), (4 * 512 * 200, (1, 128)))


def _wide_backward_pieces(gen, note) -> None:
    """(h) The backward past D = 256 under the smaller scratch caps of
    WIDE_BWD_CAPS (``_attention_bwd_cases`` at D = 384, S = 512, rate 0.1):
    the plan each forces, and the kernels against the plain version over
    its groups of heads and chunks of rows."""
    saved = flash_attention_ops.WIDE_BWD_SCRATCH_BYTES
    try:
        for cap, want in WIDE_BWD_CAPS:
            flash_attention_ops.WIDE_BWD_SCRATCH_BYTES = cap
            plan = flash_attention_ops.wide_backward_plan(HEAD_BATCH, 512, HEAD_HEADS, 384, BF16)
            log(f"# check wide backward plan at a scratch cap of {cap} bytes: {plan} (heads a "
                f"group, query rows a chunk), expected {want} {'ok' if plan == want else 'FAIL'}")
            check(plan == want, f"the wide backward's plan at cap {cap}: {plan}")
            e = _attention_bwd_cases(f"bf16 cap={cap}", BF16, HEAD_BATCH, HEAD_HEADS, 512,
                                     ATTN_RATE, gen, 384)
            note("flash_attention_train_bwd", e, BF16)
    finally:
        flash_attention_ops.WIDE_BWD_SCRATCH_BYTES = saved


def _wide_route(label: str, name: str, wide: bool, fn):
    """``fn()``, a call of the forward wrapper ``name``; with ``wide``, it
    must raise its library's count of calls that ran
    attn_fwd_wide_sm90_kernel by one (torch.profiler cannot show the route
    here: later in a full run its traces hold no device kernels)."""
    if not wide:
        return fn()
    return _route(f"{name} {label}", "attn_fwd_wide_sm90_kernel",
                  lambda: flash_attention_ops.wide_forward_calls()[name], 1, fn)


def _route(label: str, kernel: str, counter, calls: int, fn):
    """``fn()``, which must raise ``counter()`` (a library's count of the
    calls that ran ``kernel``) by exactly ``calls``: the route a check
    reads without a profiler."""
    before = counter()
    out = fn()
    ran = counter() - before
    log(f"# check {label} route: {ran} calls of {kernel}, expected {calls} "
        f"{'ok' if ran == calls else 'FAIL'}")
    check(ran == calls, f"{label}: {ran} calls of {kernel}, expected {calls}")
    return out


def _bb_wide_route(label: str, D: int, dtype, fn):
    """``fn()``, a call of ``bigbird_mid_fwd``: in bf16 past D = 64 it must
    run bigbird_fwd_wide_sm90_kernel (``_route``), in fp32 or up to 64 not."""
    wide = dtype == BF16 and D > bigbird_sparse_ops.MAX_INSTANCE_HEAD_DIM
    return _route(f"sparse fwd {label}", "bigbird_fwd_wide_sm90_kernel",
                  bigbird_sparse_ops.wide_forward_calls, int(wide), fn)


def _widest_paths(params: dict, total: dict) -> tuple:
    """(f) STonKGs ``run_pretraining`` -> ``from_pretrained`` -> ``embed``
    from a 2560-wide KG TSV (the derived config: 2 layers, 40 heads of 64,
    I = 10,240; WIDEST_ENTITIES rows, 4 steps of B=32, the embed over one
    batch of B=128, card fp32 vs CPU fp32 and bf16 by cosine), then STonKGs
    at BERT-base's widths in 3 heads of D=256 on phase 5's parameters:
    ``embed`` and phase 7's ``pretrain`` (B=32, 4 steps) and phase 8's
    numerics.  Returns the launch counts of the 2560-wide path and of the
    D=256 embed and step."""
    t0 = time.perf_counter()
    wide: dict = {}
    _widths_pretrain_files(WIDEST_TSV_WIDTH, wide, entities=WIDEST_ENTITIES,
                           steps=WIDEST_PF_STEPS, embed_rows=BATCH)
    _add_counts(total, wide)
    torch.cuda.empty_cache()
    log(f"# wide (f) {WIDEST_TSV_WIDTH}-wide path: {time.perf_counter() - t0:.1f} s")
    cfg = _heads256_cfg()
    heads = _heads_serving(cfg, params)
    train_counts, state = phase_training(cfg, params)
    heads.update(train_counts)
    del state
    phase_train_numerics(cfg)
    _add_counts(total, heads)
    torch.cuda.empty_cache()
    log(f"# wide (f) D=256: {time.perf_counter() - t0:.1f} s")
    return wide, heads


def _heads256_cfg() -> STonKGsConfig:
    return STonKGsConfig(bert=BertConfig(num_attention_heads=HEADS_256), kg_vocab_size=100_000)


def _widest_times(card: str) -> dict:
    """(g) The three FFN kernels at the 2560-wide path's shapes (the
    serving block at the trunk's M = 128 x 512, the training pair at the
    step's 32 x 512) beside their bound, plain versions and the cuBLAS
    products they contain, and the three attention kernels at the D=256
    path's shapes (``_heads_times``).  Returns, per kernel name, its
    times."""
    gen = torch.Generator(device=DEV).manual_seed(29)
    H, I = WIDEST_TSV_WIDTH, 4 * WIDEST_TSV_WIDTH
    M, Mt = BATCH * 512, TRAIN_BATCH * 512
    times = {"ffn_ln_block": _time_ffn(f"H={H} trunk M={M}", M, gen, H, I),
             "ffn_train_fwd": _time_train_ffn(f"H={H} step M={Mt}", Mt, gen, False, H, I),
             "ffn_train_bwd": _time_train_ffn(f"H={H} step M={Mt}", Mt, gen, True, H, I)}
    for name, t in times.items():
        log(f"# time {name} H={H} bf16 ({card}): {json.dumps(t)}")
    torch.cuda.empty_cache()
    times.update(_heads_times(_heads256_cfg(), card))
    torch.cuda.empty_cache()
    return times


def _heads384_cfg() -> STonKGsConfig:
    return STonKGsConfig(bert=BertConfig(num_attention_heads=HEADS_384), kg_vocab_size=100_000)


def _heads384_path(params: dict, total: dict) -> dict:
    """(i) STonKGs at BERT-base's widths in 2 heads of D=384 on phase 5's
    parameters, as (f) in 3 heads of 256: ``embed`` over ROWS rows at
    B=128 and phase 7's ``pretrain`` (B=32, 4 steps; every backward on the
    dS pass and GEMMs of attention_bwd_wide_sm90.cuh, the library's count
    of its calls) and phase 8's numerics.  Returns the launch counts of
    the embed and step."""
    t0 = time.perf_counter()
    cfg = _heads384_cfg()
    heads = _heads_serving(cfg, params)
    wide0 = flash_attention_ops.wide_backward_calls()
    train_counts, state = phase_training(cfg, params)
    ran = flash_attention_ops.wide_backward_calls() - wide0
    launched = train_counts["flash_attention_train_bwd"]
    log(f"# check D=384 step route: {ran} calls of the backward's dS pass and GEMMs, "
        f"{launched} launches of flash_attention_train_bwd "
        f"{'ok' if ran == launched > 0 else 'FAIL'}")
    check(ran == launched > 0, "the D=384 step did not run the wide backward at every call")
    heads.update(train_counts)
    del state
    phase_train_numerics(cfg)
    _add_counts(total, heads)
    torch.cuda.empty_cache()
    log(f"# wide (i) D=384: {time.perf_counter() - t0:.1f} s")
    return heads


def _any_width_times(card: str) -> dict:
    """(j) The three FFN kernels at the 4-wide path's shapes (the serving
    block at the trunk's M = 128 x 512, the training pair at the step's 32
    x 512) beside their bound, plain versions and the cuBLAS products they
    contain, and the three attention kernels at the D=384 path's shapes
    (``_heads_times``).  Returns, per kernel name, its times."""
    gen = torch.Generator(device=DEV).manual_seed(29)
    H, I = TINY_FFN[0]
    M, Mt = BATCH * 512, TRAIN_BATCH * 512
    times = {"ffn_ln_block": _time_ffn(f"H={H} trunk M={M}", M, gen, H, I),
             "ffn_train_fwd": _time_train_ffn(f"H={H} step M={Mt}", Mt, gen, False, H, I),
             "ffn_train_bwd": _time_train_ffn(f"H={H} step M={Mt}", Mt, gen, True, H, I)}
    for name, t in times.items():
        log(f"# time {name} H={H} bf16 ({card}): {json.dumps(t)}")
    times.update(_heads_times(_heads384_cfg(), card))
    torch.cuda.empty_cache()
    return times


def phase_wide(card: str, params: dict) -> tuple:
    """Phase 29: (a) the FFN kernels at hidden widths from 16 to 2048 with
    the planted faults, (b) the BigBird pair at head widths from 4 to 520
    with the planted faults (the refused geometries are phase 10's and
    27's), (c) the STonKGs and ProtSTonKGs paths from KG TSVs whose
    derived configs run them (4 to 1280 wide); past the earlier domains,
    (d) the FFN kernels at H from 2056 to 8192 and I up to 32,768, (e) the
    attention kernels at D from 136 to 256, each with a planted fault, (f)
    STonKGs from a 2560-wide KG TSV and at 3 heads of D=256 on phase 5's
    ``params``, (g) the kernels' times at (f)'s shapes; past the last
    domains, (h) the FFN kernels at H or I below 8 and the attention
    kernels at D from 264 to 2,560, with planted faults, (i) STonKGs at 2
    heads of D=384 on ``params``, (j) the kernels' times at (i)'s and the
    4-wide path's shapes.  Returns (the launch counts of every counted
    run, summed; per kernel, the worst bf16 error of (a), (b), (d), (e)
    and (h); the counts of the 2560-wide path; the counts of the D=256
    embed and step; per kernel, the worst bf16 error of (d) and (e); (g)'s
    times; and a dict of (h)-(j): "errs" (per kernel, the worst bf16 error
    of (h)), "d384" (the D=384 embed's and step's counts), "h4" (the
    4-wide path's counts), "times" ((j)'s))."""
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(29)
    errs: dict = {}
    widest: dict = {}
    any_errs: dict = {}

    def note(name, err, dtype):
        if dtype == BF16:
            errs[name] = max(errs.get(name, 0.0), err)

    def note_widest(name, err, dtype):
        note(name, err, dtype)
        if dtype == BF16:
            widest[name] = max(widest.get(name, 0.0), err)

    def note_any(name, err, dtype):
        note(name, err, dtype)
        if dtype == BF16:
            any_errs[name] = max(any_errs.get(name, 0.0), err)

    card_gen = torch.Generator(device=DEV).manual_seed(29)
    _wide_ffn(card_gen, note)
    log(f"# wide (a) FFN kernels: {time.perf_counter() - t_phase:.1f} s")
    _wide_bigbird(gen, note)
    log(f"# wide (b) BigBird pair: {time.perf_counter() - t_phase:.1f} s")
    total: dict = {}
    h4_counts = _wide_paths(total)
    log(f"# wide (c) paths: {time.perf_counter() - t_phase:.1f} s")
    _widest_ffn(card_gen, note_widest)
    log(f"# wide (d) FFN kernels past H=2048: {time.perf_counter() - t_phase:.1f} s")
    _widest_attention(card_gen, note_widest)
    log(f"# wide (e) attention kernels past D=128: {time.perf_counter() - t_phase:.1f} s")
    wide_counts, head_counts = _widest_paths(params, total)
    times = _widest_times(card)
    log(f"# wide (f, g): {time.perf_counter() - t_phase:.1f} s")
    _tiny_ffn(card_gen, note_any)
    _widest_attention(card_gen, note_any, WIDEST_ANY_HEAD_DIMS)
    _wide_backward_pieces(card_gen, note_any)
    log(f"# wide (h) FFN below 8, attention past D=256: {time.perf_counter() - t_phase:.1f} s")
    d384_counts = _heads384_path(params, total)
    any_times = _any_width_times(card)
    log(f"# wide phase: {time.perf_counter() - t_phase:.1f} s ({card})")
    return total, errs, wide_counts, head_counts, widest, times, {
        "errs": any_errs, "d384": d384_counts, "h4": h4_counts, "times": any_times}


def main() -> int:
    t_last = [time.perf_counter()]

    def lap(phases: str) -> None:
        """Log the seconds since the last lap, with the phases they ran."""
        now = time.perf_counter()
        log(f"# seconds of phases {phases}: {now - t_last[0]:.1f}")
        t_last[0] = now

    try:
        card = phase_device()
        phase_build()
        lap("0-1 (device, build)")
        errs = phase_kernels()
        lap("2 (serving kernels)")
        errs.update(phase_train_kernels())
        lap("3 (training kernels)")
        cfg = STonKGsConfig(bert=BertConfig(), kg_vocab_size=100_000)
        engine, bucketed, feats, counts, params = phase_serving(cfg)
        times = phase_timing(cfg, engine, bucketed, feats)
        del engine, bucketed
        lap("5-6 (serving, timing)")
        train_counts, state = phase_training(cfg, params)
        counts.update(train_counts)
        phase_train_numerics(cfg)
        times.update(phase_train_timing(cfg, state))
        del state          # params (CPU, fp32) stay for the int8 path
        lap("7-9 (training)")
        errs.update(phase_sparse_kernels())
        lap("10 (sparse kernels)")
        pcfg = _prot_cfg()
        engine, pfeats, prot_counts, pparams = phase_prot_serving(pcfg)
        for name, c in prot_counts.items():
            counts[name] = counts.get(name, 0) + c
        lap("11 (ProtSTonKGs serving)")
        prot_train_counts, pstate, loss_fn = phase_prot_training(pcfg, pparams)
        for name, c in prot_train_counts.items():
            counts[name] = counts.get(name, 0) + c
        lap("12 (ProtSTonKGs training)")
        phase_prot_train_numerics(pcfg)
        phase_prot_train_numerics(pcfg, block_size=128)
        lap("13 (ProtSTonKGs training numerics, blocks 64 and 128)")
        prot_times = phase_prot_timing(pcfg, engine, pfeats, pstate, loss_fn)
        del pstate, loss_fn
        lap("14 (ProtSTonKGs timing)")
        counts128, times128 = phase_prot_block128(pcfg, pparams, pfeats, prot_times, card)
        for name, c in counts128.items():
            counts[name] = counts.get(name, 0) + c
        # the kernel line keeps block 64's times and takes the worse error
        for name in ("bigbird_mid_fwd", "bigbird_mid_bwd"):
            times[name] = dict(prot_times[name], max_abs_err=max(
                prot_times[name]["max_abs_err"], *(t["max_abs_err"] for k, t in
                                                   times128.items() if k.startswith(name))))
        for name in ("ffn_ln_block", "flash_attention_infer", "ffn_train_fwd", "ffn_train_bwd",
                     "flash_attention_train_fwd"):
            times[name]["max_abs_err"] = max(times[name]["max_abs_err"], *(
                t["max_abs_err"] for k, t in prot_times.items() if k.startswith(name + ":")))
        lap("25 (ProtSTonKGs at block 128)")
        errs.update(phase_int8_kernels())
        int8_counts, int8_wide = phase_int8_serving(cfg, params, feats)
        for counted in (int8_counts, int8_wide["total"],
                        phase_prot_int8_serving(pcfg, pparams, engine, pfeats)):
            for name, c in counted.items():
                counts[name] = counts.get(name, 0) + c
        del engine
        int8_times, times["int8_gemm"], counts["int8_gemm"] = phase_int8_timing()
        # the trunk's FFN-in shape goes into the kernel line, with the
        # worst error of every path shape
        times["dense_int8"] = dict(int8_times["trunk FFN in"], max_abs_err=max(
            t["max_abs_err"] for t in int8_times.values()))
        lap("15-18 (int8)")
        for name, c in phase_readme(card).items():
            counts[name] += c
        lap("19 (README flow)")
        ft_counts, ft_times = phase_finetune(card, params, pparams)
        for name, c in ft_counts.items():
            counts[name] += c
        lap("20 (fine-tuning)")
        for name, c in phase_pretrain_files(card).items():
            counts[name] += c
        lap("21 (pre-training from files)")
        for name, c in phase_kg_embeddings(card).items():
            counts[name] += c
        lap("22 (KG embeddings)")
        for name, c in phase_parallel(card, params, pparams).items():
            counts[name] += c
        lap("23 (parallel)")
        for name, c in phase_cli(card, params, pparams).items():
            counts[name] += c
        lap("24 (CLI)")
        width_total, width_counts, width_errs, width_times = phase_widths(card)
        for name, c in width_total.items():
            counts[name] += c
        lap("26 (widths)")
        bb_total, bb_errs, bb_times, (bs25_counts, bs25_times), (d128_counts, d128_times) = \
            phase_bigbird_widths(card, pcfg, pparams)
        del pparams
        for name, c in bb_total.items():
            counts[name] += c
        lap("27 (BigBird widths)")
        head_total, head_counts, head_errs, head_times = phase_head_widths(card, params)
        for name, c in head_total.items():
            counts[name] += c
        lap("28 (head widths)")
        wide_total, wide_errs, w2560_counts, d256_counts, widest_errs, widest_times, anyw = \
            phase_wide(card, params)
        del params
        lap("29 (wide)")
        for name, c in wide_total.items():
            counts[name] += c
        # the worst bf16 error at the new widths goes into the kernel line
        for name, e in wide_errs.items():
            errs[name] = max(errs[name], e)
        # the fine-tuning shapes' worst error goes into the kernel line
        for key, t in ft_times.items():
            name = key.split(":")[0]
            times[name]["max_abs_err"] = max(times[name]["max_abs_err"], t["max_abs_err"])
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    attn_cu = "stonkgs_tpu_torch/csrc/flash_attention_train.cu"
    ffn_cu = "stonkgs_tpu_torch/csrc/ffn_train.cu"
    sparse_cu = "stonkgs_tpu_torch/csrc/bigbird_sparse.cu"
    sources = {"ffn_ln_block": ("stonkgs_tpu_torch/csrc/ffn_ln_block.cu",
                                "stonkgs_tpu/ops/fused_ffn.py:438"),
               "flash_attention_infer": ("stonkgs_tpu_torch/csrc/flash_attention_infer.cu",
                                         "stonkgs_tpu/ops/flash_attention.py:359"),
               "flash_attention_train_fwd": (attn_cu, "stonkgs_tpu/ops/flash_attention.py:92"),
               "flash_attention_train_bwd": (attn_cu, "stonkgs_tpu/ops/flash_attention.py:118"),
               "ffn_train_fwd": (ffn_cu, "stonkgs_tpu/ops/fused_ffn.py:54"),
               "ffn_train_bwd": (ffn_cu, "stonkgs_tpu/ops/fused_ffn.py:206"),
               "bigbird_mid_fwd": (sparse_cu, "stonkgs_tpu/ops/bigbird_sparse_pallas.py:83"),
               "bigbird_mid_bwd": (sparse_cu, "stonkgs_tpu/ops/bigbird_sparse_pallas.py:113"),
               "dense_int8": ("stonkgs_tpu_torch/csrc/dense_int8.cu",
                              "stonkgs_tpu/ops/quantization_pallas.py:33"),
               "int8_gemm": ("stonkgs_tpu_torch/csrc/int8_gemm.cu",
                             "benchmarks/bench_int8_gemm.py:27")}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name in sources:
        src, replaces = sources[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[name],
                        **{k: times[name][k] for k in keys},
                        "max_abs_err": max(errs[name], times[name]["max_abs_err"])})
    # the six kernels at MiniLM-L12-H384's widths (H=384, D=32): launches of
    # its embed and step, the worst bf16 error of phase 26 at every new width
    for name in WIDTH_KERNELS:
        src, replaces = sources[name]
        t = width_times[name]
        kernels.append({"name": f"{name} H=384 D=32", "route": "cuda", "source": src,
                        "replaces": replaces, "launches": width_counts[name],
                        **{k: t[k] for k in keys},
                        "max_abs_err": max(width_errs[name], t["max_abs_err"])})
    # the pair at D=32 and block 512 (the 128-wide ProtSTonKGs path): launches
    # of phase 27's runs, the worst bf16 error of phase 27 at any new geometry
    for name in ("bigbird_mid_fwd", "bigbird_mid_bwd"):
        src, replaces = sources[name]
        t = bb_times[name]
        err = max(bb_errs[name], t["max_abs_err"], *(x["max_abs_err"] for k, x in
                                                    bb_times.items() if k.startswith(name + ":")))
        kernels.append({"name": f"{name} D=32", "route": "cuda", "source": src,
                        "replaces": replaces, "launches": bb_total[name],
                        **{k: t[k] for k in keys}, "max_abs_err": err})
    # the three attention kernels at 6 heads of D=128 (phase 28 (b)'s
    # shapes): launches of its embed and step, the worst bf16 error of
    # phase 28 at any head width
    for name in HEAD_KERNELS:
        src, replaces = sources[name]
        t = head_times[name]
        kernels.append({"name": f"{name} D=128", "route": "cuda", "source": src,
                        "replaces": replaces, "launches": head_counts[name],
                        **{k: t[k] for k in keys},
                        "max_abs_err": max(head_errs[name], t["max_abs_err"])})
    # past the earlier domains: the three FFN kernels at H=2560 (the
    # 2560-wide path's launches and shapes) and the three attention kernels
    # at D=256 (the 3-head path's), with the worst bf16 error of phase 29
    # (d) and (e); the int8 dense at K=100 (the 100-wide int8 engine's
    # launches, the trunk's FFN-in shape, the worst bf16 error at any K)
    for name, tag, launched in (
            *((n, "H=2560", w2560_counts) for n in ("ffn_ln_block", "ffn_train_fwd",
                                                      "ffn_train_bwd")),
            *((n, "D=256", d256_counts) for n in HEAD_KERNELS)):
        src, replaces = sources[name]
        t = widest_times[name]
        kernels.append({"name": f"{name} {tag}", "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launched[name],
                        **{k: t[k] for k in keys},
                        "max_abs_err": max(widest_errs[name], t["max_abs_err"])})
    src, replaces = sources["dense_int8"]
    t = int8_wide["time"]
    kernels.append({"name": "dense_int8 K=100", "route": "cuda", "source": src,
                    "replaces": replaces, "launches": int8_wide["counts"]["dense_int8"],
                    **{k: t[k] for k in keys}, "max_abs_err": int8_wide["err"]})
    # past the last domains: the pair at block 25 (the S = 200 store's
    # launches and shapes; the worst bf16 error of phase 27 at any
    # geometry) and at D = 128 (the 6-head ProtSTonKGs path's; the worst
    # bf16 error of phase 29's pair checks), the three attention kernels
    # at D = 384 (the 2-head path's) and the three FFN kernels at H = 4
    # (the 4-wide path's), with the worst bf16 error of phase 29 (h)
    for name, tag, launched, t, err in (
            *((n, "bs=25", bs25_counts, bs25_times, bb_errs[n])
              for n in ("bigbird_mid_fwd", "bigbird_mid_bwd")),
            *((n, "D=128", d128_counts, d128_times, wide_errs[n])
              for n in ("bigbird_mid_fwd", "bigbird_mid_bwd")),
            *((n, "D=384", anyw["d384"], anyw["times"], anyw["errs"][n]) for n in HEAD_KERNELS),
            *((n, "H=4", anyw["h4"], anyw["times"], anyw["errs"][n])
              for n in ("ffn_ln_block", "ffn_train_fwd", "ffn_train_bwd"))):
        src, replaces = sources[name]
        err = max(err, t[name]["max_abs_err"], *(x["max_abs_err"] for k, x in t.items()
                                                 if k.startswith(name + ":")))
        kernels.append({"name": f"{name} {tag}", "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launched[name],
                        **{k: t[name][k] for k in keys}, "max_abs_err": err})
    log(f"# card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
