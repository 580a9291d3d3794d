#!/usr/bin/env python3
"""Drive the PyTorch port's ResNet-50, MobileNet-v1, DenseNet-121 and
ResNeXt-50 serving and train paths, the whole-bottleneck-block kernel,
the Trainer (RN26@32 fit, checkpoint, resume, test; its epochs replayed
as CUDA graphs, resident and chunked), the single-file
serving artifact and the device data path (augmented RN26@32 fit → export
→ serve, RN50@224 served from the artifact), LeNet, ConvNet, the template
net, VGG-16, SqueezeNet and InceptionNet-v1, the CLI (python -m
convnets_tpu_torch) and the tuner, and AlexNet, SENet, SE-ResNet, SKNet,
SK-ResNet and ShuffleNet-v1 on the widened conv kernels (dilation, wide
groups, any dense stride), and DenseNet's shared-statistics block,
train-mode Remat, the debug trace, the side-stream host feed and
adaptive_avg_pool2d, data parallel (a world of one rank over NCCL, two
ranks sharing the card over gloo, the CLI under torchrun), the Winograd
path, the native image codec on the card's host, and the public API
(the summaries, a user's Builder network, conv2d_winograd), on one NVIDIA
GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in the order they run; any failure exits non-zero without the
final line:
  0. device: needs CUDA (no CPU fallback); prints the card's name and
     power limit as nvidia-smi reports them.
  1. build: compiles convnets_tpu_torch/csrc/*.cu with nvcc (sm_90a), one
     compiler per source, all started together.
  1b. SASS: the HGMMA instructions of every tensor-core conv instantiation
     (cuobjdump -sass; none may have 0), the grouped mode's 8 among them
     (Cin/G = 4, 8, 16, 32, both epilogues), the block's 3 (Cmid = 64,
     128, 256), and no bf16 instantiation of the dense CUDA-core conv loop.
  2a. conv plans vs plain: every branch of conv_plan (PLAN_SHAPES: the
     7x7x3 stem at N=1, the 3x3x3 stem, Cin=12, Cout=32, 24 and 27, a 1x1
     stride-2 p0, Cin=40, M=49 < BM, two RN50 shapes at b256), fp32 and
     bf16, both epilogues (y with and without scale/shift/ReLU; y, Σy, Σy²).
  2. serving kernels vs plain: every distinct conv shape of the port's own
     RN50@224 modules, at batch 8, fp32 (TF32 off) and bf16, with and
     without ReLU, plus the stem max-pool, each against its plain PyTorch
     version on the card; max error, tolerance and CUDA-event times.
  4. train kernels vs plain: conv2d_stats (y, Σy, Σy²) and its reduction
     at every distinct RN50@224 conv shape at batch 8 in fp32 and bf16;
     conv_bn_relu_train and conv2d_train forward and gradients at the stem
     and a 3x3/2 shape; pool2d_train dx at the stem pool (exact).
  4b. conv2d_fused, conv2d_stats and conv2d_fused with no epilogue (the
     forward of conv2d_train) in bf16 at batch 256 at every distinct
     RN50@224 shape, beside cuDNN's bf16 F.conv2d: ms and TFLOP/s per
     shape, summed by layer use into the kernels line (ms_b256,
     library_ms_b256, bound_ms_b256).
  4c. the BN passes of the fused conv sites (csrc/bn_act.cu) vs plain:
     bn_act_forward (normalize + ReLU from the conv's (2, C) sums) and
     bn_act_backward (partial sums, their reduction, the apply pass) at
     every distinct fused-site shape of RN50@224 at batch 8 (fp32 and bf16,
     ReLU on and off) and at b256 (bf16), at RN26@32's at b256 and at C = 6
     on the loop route: out within one bf16 ulp (fp32 1e-6 of max|ref|)
     off the ReLU-mask flips (at most 1e-4 of the elements), mean and var
     within 1e-6, the backward's sums within 1e-4, dy within CONV_TOL,
     every launch on its route; the backward's recomputed mask against the
     forward's, exactly (Σdz of an integer cotangent); device ms at N=8
     and b256 of both kernels, their plain versions and ATen's
     F.batch_norm + relu forward and backward (a yardstick the port never
     calls), summed over RN50's 53 sites into rows 6, bn_act_forward and
     bn_act_backward.
  5. the train slice, RN50 at 3x224x224, 1000 classes, weights made with
     numpy from --seed in the JAX variable layout and loaded by the bridge:
     (i) one fp32 SGD step at batch 8, kernel path vs plain path (loss,
     every gradient, BN running statistics); (ii) ten bf16 Adam steps on
     one batch of 32, the kernel path's loss must fall; (iii) bf16
     throughput at batch 256 with bench.py's settings (Adam, weight decay
     1e-4, dropout 0.5), synthetic uint8 batch on the card, kernel and
     plain paths in turns, launches per step (exactly 53 conv2d_stats, 53
     reductions, 53 bn_act_forward + 53 × 3 bn_act_backward launches, 1
     max_pool2d, 0 conv2d_fused), peak memory and a
     torch.profiler split of three steps; (iv) one step of the
     batch_norm=False RN50 at batch 32 (53 conv2d_fused launches, finite
     gradients).
  3. the serving slice, on the bf16 RN50 that phase 5 (ii) trained (with
     the served normalization; zero-learning-rate steps then bring its BN
     running statistics to its batch, so eval mode computes what it
     learned): its 32 training images as uint8 requests at batch 1, 8 and
     64 with baked normalization; finite logits, exactly 53 conv and 1
     pool launch per forward, argmax agreement with the plain versions,
     the count of distinct classes and the share served as the learned
     label; an fp32 forward vs plain; serving img/s at batch 64 and 256
     (kernel and plain paths in turns) and a torch.profiler table of
     three b64 requests, with the bytes of each host-to-device copy read
     from its memcpy events (the uint8 request's, not 4x them as fp32)
     and a copy's share of a request's device time (every family).
  6. this slice's kernels vs plain, batch 8, fp32 (TF32 off) and bf16:
     depthwise_conv2d at the 9 distinct MobileNet-v1@224 depthwise shapes,
     avg_pool2d at the 3 DenseNet-121@224 transitions; depthwise_train
     forward and dx/dw at a stride-1 and a stride-2 shape; pool2d_train in
     avg mode, forward and dx, at the first transition.
  7. MobileNet-v1 and DenseNet-121 at 3x224x224, 1000 classes, weights
     from --seed in the JAX layout, each as phases 5 and 3 drive RN50:
     (i) the fp32 SGD step at batch 8, kernel vs plain, with the
     perturbed-weight control; (ii) ten bf16 Adam steps on one batch of
     32, the loss must fall; (iii) serving that trained model: uint8
     requests at batch 8 and 64 (exact launches per forward: MobileNet 14
     conv2d_fused + 13 depthwise_conv2d; DenseNet-121 120 conv2d_fused + 1
     max_pool2d + 3 avg_pool2d), argmax agreement with the plain path,
     distinct classes, an fp32 forward vs plain, serving img/s at batch
     256; (iv) bench.py's train step at TRAIN_BATCH[arch] (exact launches
     per step: MobileNet 14 conv2d_stats + 14 reductions + 13 depthwise;
     DenseNet-121 1 conv2d_stats + 1 reduction + 119 conv2d_fused + 1
     max_pool2d + 3 avg_pool2d), img/s on both paths in turns, peak memory
     and a profiler split.
  8. this slice's kernels vs plain, fp32 (TF32 off) and bf16: the grouped
     conv at the 7 distinct ResNeXt-50@224 grouped shapes at batch 8, each
     with its grouped_plan route (bf16 must be wgmma, fp32 simt), both
     epilogues (y with and without scale/shift/ReLU; y, Σy, Σy², the sums
     against those of the kernel's own stored y), the bf16 simt route
     timed beside; both epilogues at every branch of grouped_plan
     (GROUPED_PLAN_SHAPES: Cin/G = 4, 8, 16, 32 at N=1, stride 2, p0, a
     1x1, and two bf16 simt shapes);
     grouped_conv2d_train and grouped conv_bn_relu_train forward and
     gradients at a stride-1 and a stride-2 shape; bottleneck_block at
     RN50's three identity shapes (56²×256/64, 28²×512/128, 14²×1024/256)
     at batch 8 on its block_plan routes (bf16 wgmma, fp32 simt), the bf16
     wgmma route also against the simt route on the same inputs, one
     relu_out=False case and one zero-halo case (W1 = 0, b1 > 0) in bf16,
     and a bf16 shape off the wgmma route (Cmid = 32, simt); then the block
     A/B of scripts/tpu_block_ab.py at batch 256, chains of 6 and 4 blocks:
     the kernel (every launch on the wgmma route), the simt route, its plain
     version, the port's serving composition (three conv2d_fused launches,
     the add and the ReLU) and three cuDNN convs, with ms per chain, TFLOP/s
     and each arm's ratio to the kernel.
  8b. rows 1g and 5g and row 8's forward (grouped_conv2d_fused with no
     epilogue) in bf16 at batch 256 at the 7 grouped shapes: the wgmma
     route, the simt route on the same inputs, cuDNN's bf16 grouped
     F.conv2d and the bound, ms and TFLOP/s per shape, summed by layer use
     into the kernels line (ms_b256, simt_ms_b256, library_ms_b256,
     bound_ms_b256).
  9. ResNeXt-26 (32x4d; the depth is cut from ResNeXt-50 to keep the whole
     run well inside its time limit; phases 8 and 8b keep ResNeXt-50's
     grouped shapes) at 3x224x224, 1000 classes, weights from --seed in
     the JAX layout, as phase 7 drives its families (exact launches per
     forward: 21 conv2d_fused + 8 grouped_conv2d_fused + 1 max_pool2d;
     per step: 21 conv2d_stats + 8 grouped_conv2d_stats + 29 reductions +
     1 max_pool2d), then (v) one step of the batch_norm=False ResNeXt-26 at
     batch 32 (8 grouped_conv2d_train forwards, finite gradients).
  10. the Trainer on RN26@32 (CINIC-shaped), bf16, bench.py:93-98's
     settings without augmentation (SGD lr 0.05, momentum 0.9, the
     per-example-mean objective, step decay every 2 epochs, dropout 0.5,
     batch 256), 8,192 train and 2,048 valid uint8 images of
     synthetic_dataset(learnable=True) from --seed in a shuffled DataLoader:
     (i) fit 2 epochs; the best checkpoint exists and get_last_checkpoint
     finds it; every train step launches exactly n conv2d_stats, n
     reductions, 1 max_pool2d and 1 pool2d_backward, every eval batch n
     conv2d_fused and 1 max_pool2d (n = 29, read off the model); every
     batch reaches the card as uint8 (786,432 B); then every distinct conv
     shape of the fitted model (23 for 29 convs) at b256 bf16 on the
     wgmma route and at b64 fp32 on simt: conv2d_fused (both epilogues)
     and conv2d_stats against their plain versions with phases 2 and 4's
     bars, and the stem max_pool2d and pool2d_train (forward, and dx
     through pool2d_backward) exactly, on the vector route; (ii) a fresh
     model and Trainer load the checkpoint (params and BN buffers equal to the
     file's) and resume for 1 epoch: the history, the step schedule, the
     falling train loss and a valid accuracy above 0.2; (iii) evaluate and
     test on the valid loader (confusion matrix, img/s, ms per image),
     then reestimate_bn over its 8 full batches (per batch n conv2d_stats,
     n reductions and 1 max_pool2d; parameters unchanged, every running
     statistic moved, eval mode after it, accuracy still above 0.2);
     (v) one train epoch under torch.profiler (idle share; each image copy
     it records 786,432 B); (iv) phase 5 (i)'s one fp32 SGD step at
     RN26@32 b64, every gradient leaf kernel vs plain within 0.1 (‖Δ‖/‖g‖)
     beside the 1e-7 control, and a lower-precision control (the plain
     path in bf16) that must fall outside that bar; then one fp32 epoch at
     batch 64 on 1,024 images (lr 1e-5), kernel vs plain path, the bar 10x
     a control (the plain fit with its conv weights perturbed by 1e-6
     relative), at most 1e-2, the plain path in bf16 printed beside; (v)
     the Trainer's epoch img/s beside the raw step loop on one batch on the card. Prints
     the trainer JSON line.
  11. the single-file artifact and the device data path: (i) RN50@224
     (weights from --seed) exported with serve.save_artifact as a bf16
     and an fp32 artifact (uint8 wire, baked normalization, symbolic
     batch); one bf16 artifact, loaded with load_artifact, serves batches
     1, 64 and 256: per request exactly 53 conv2d_fused + 1 max_pool2d
     launches, the conv_plan tiles each batch ran (b1 and b256 differ),
     argmax agreement with the live ServingModel >= 0.99 (and whether
     bit-identical), the fp32 artifact within 1e-6 x max |logit| of the
     live fp32 model, the b64 request's host-to-device bytes (uint8 only),
     img/s at b64 and b256 artifact and live in turns, and the host µs per
     call of the conv2d_fused op beside its wrapper; an RN26@32 artifact
     exported on the CPU served on the card; (ii) a fresh process loads
     the artifact and serves one request without importing
     convnets_tpu_torch.models (its launches, its argmax equal to this
     process's); (iii) RN26@32 fit for 3 epochs with the JAX defaults
     (data_augment, affine, data_norm) plus cutout 8 and mixup 0.2 on
     phase 10's data, through DataMngr's route to DeviceCacheLoader, whose
     epochs the Trainer runs as replays of one captured step: the splits'
     one-time uint8 copies, every train step 29 conv2d_stats + 29
     reductions + 1 max_pool2d + 1 pool2d_backward (a replay's from the
     per-replay tally), loss falls, valid accuracy > 0.2, a profiled
     replayed epoch whose only host-to-device copies are the epoch's index
     and weight matrices, its idle share, and the preprocessing's share of
     a step; (iv) that model exported and served
     on its valid split, argmax = Trainer.test's on >= 0.99; (v) every
     augmentation function on the card against the CPU with the same
     parameters (fp32, max |Δ| <= 1e-5), and one RN50@224 b256 train step
     on 256² uint8 images (RandomResizedCrop on the card), its ms beside
     the preprocessing's. Prints the artifact JSON line.
  12. the zoo's first group, the CLI and the tuner: (i) LeNet, ConvNet,
     mynetwork, VGG-16, SqueezeNet 1.1 and InceptionNet-v1 at 3x32x32 and
     SqueezeNet 1.0 at 3x224x224, 10 classes, weights from --seed in the
     JAX layout: fp32 eval logits kernel vs plain at b8 (<= 1e-4 x max
     |logit|), phase 5 (i)'s fp32 SGD step at b8 with its control, ten
     bf16 Adam steps on one batch of 32 (the loss falls), exact launches
     per eval forward (n conv2d_fused + p max_pool2d) and per train step
     (n conv2d_stats + n reductions + p max_pool2d + p pool2d_backward;
     model_launches, from the model's modules), serving at b256 (the
     kernel path's logits against the plain path's: argmax agreement >=
     0.99; img/s, the paths in turns), then every distinct conv and
     max-pool shape of the seven models at b8 in bf16 and fp32, and of the
     six 32² ones at b128 in bf16 (the CLI fits' and the tuner's batch),
     against the plain versions (layer_check); (ii) the
     CLI in process (convnets_tpu_torch.__main__.main) on a CINIC-shaped
     PNG tree (2,560 / 640 / 640 images of synthetic_dataset): fit RN26 2
     epochs at b256 → load --testing → load --resume --epochs 3 → export
     --bake-norm → load --testing (the fits and evaluations replayed
     graphs over DataMngr's DeviceCacheLoaders), every train step 29
     conv2d_stats + 29 reductions + 1 max_pool2d + 1 pool2d_backward and
     every eval call 29 conv2d_fused + 1 max_pool2d, the artifact served by a fresh process on
     the test split (argmax = Trainer.test's on >= 0.99), epoch and test
     img/s; fit each 32² family 2 epochs at b128 (the loss finite and
     falling, the launches per call, img/s); `python -m convnets_tpu_torch
     fit --arch lenet --sanity-check` as a subprocess (exit 0, a
     checkpoint) and again under CUDA_VISIBLE_DEVICES= (non-zero, naming
     the missing device); (iii) process_tune on mynetwork, 3 samples of one
     epoch with seed 0 (batch_norm False, False, True: both the
     conv2d_stats and the conv2d_train step run, counted), the tuned
     checkpoint's tuning_results, the reloaded winner's valid score equal
     to the best sampled one. Prints the cli JSON line.
  13. the replayed-graph epoch (train/graph.py: one train and one eval
     step captured as CUDA graphs over static buffers, replayed once per
     batch): (i) RN26@32 bf16 b256 with phase 11's settings (affine,
     cutout 8, mixup 0.2, SGD, dropout 0.5) on 8,100 train images (the
     last batch padded by index 0 at weight 0) and phase 10's valid split,
     from the same weights, 2 epochs graphed, per-step and per-step again
     (the control) in turns: every parameter and BN buffer, each epoch's
     loss and score and evaluate's loss and predictions, graphed against
     per-step: bit-identical where the control is, else within 10x the
     control's own gap per leaf; (ii) every graphed train step exactly 29
     conv2d_stats + 29 reductions + 1 max_pool2d + 1 pool2d_backward and
     every eval batch 29 conv2d_fused + 1 max_pool2d from the per-replay
     tally, mixup's λ as a device scalar bit-identical to the CPU scalar,
     and a profiled graphed epoch whose only host-to-device copies are its
     index and weight matrices; (iii) the graphed and per-step epochs'
     img/s (host clock around _run_train_epoch, fenced by its read-back),
     device ms per step and the idle share, the capture's seconds; (iv)
     RN50@224 bf16 b256 with bench.py:39-43's settings over 4,096 uint8
     images (0.617 GB): two chunked epochs (ShardRotationLoader, 256 MiB
     chunks: 3 of 6 batches, the last one's 2 empty batches not run)
     against two resident graphed epochs (DeviceCacheLoader) and two more
     (the control), same permutations, phase (i)'s bar, their img/s and
     peak device memory. Prints the graph JSON line.
  14. the rest of the zoo on the widened conv kernels: (i) against their
     plain versions, fp32 (TF32 off) and bf16, both epilogues (y with and
     without scale/shift/ReLU; y, Σy, Σy² with the sums against those of
     the kernel's own stored y), each on the route its plan gives it: every
     distinct dilated grouped shape of SKNet-26 and SK-ResNet-26 at 32² (b64
     fp32, b256 bf16) and of SKNet-50 at 224² (b8), every distinct
     wide-group shape (Cin/G > 32) of ShuffleNet-v1 g2, g3, g4 and g8 at 32²
     and 224² (b8), AlexNet's 11x11/4 stem at 224² (b8, b256) and a dilated
     dense 3x3 (b8, b256); SKNet-50's dilated grouped 3x3s and the 224²
     wide-group 1x1s also at b256 bf16; the b256 bf16 calls timed beside
     cuDNN's bf16 F.conv2d of the same stride, dilation and groups and the
     bound (the rows' zoo2_*_b256 keys, zoo2_224_*_b256 at 224²);
     conv_bn_relu_train on a dilated grouped shape,
     grouped_conv2d_train on a wide one and conv2d_train at stride 4,
     forward and gradients; (ii) AlexNet-cifar, SENet-26, SE-ResNet-26,
     SKNet-26, SK-ResNet-26 and ShuffleNet-v1-g4 at 3x32x32 and
     AlexNet-imagenet at 3x224x224, 10 classes, weights from --seed in the
     JAX layout, each as phase 12 (i) drives its families (fp32 logits, the
     fp32 SGD step with its control, bf16 learning, exact launches per
     forward and step from model_launches, b256 serving against the plain
     path and its img/s); a profiled b256 request of SK-ResNet-26 and of
     ShuffleNet-g4 with no library convolution kernel in it; one step of
     the batch_norm=False SK-ResNet-26 and ShuffleNet-g4 at b32 (rows 7 and
     8); (iii) the CLI in process on phase 12's PNG tree: fit SE-ResNet-26,
     SK-ResNet-26 and ShuffleNet-g4 at b256 for 2 epochs (replayed graphs
     over DataMngr's DeviceCacheLoaders; launches per call, the falling
     loss, epoch img/s, a profiled epoch's idle share), export SK-ResNet-26
     and ShuffleNet-g4, served by a fresh process on the test split against
     Trainer.test's argmax. Prints the zoo2 JSON line.
  15. the last single-card modules, at 3x224x224, 1000 classes, bf16
     unless stated: (i) DenseNet-121 with the shared-statistics
     DenseBlockFused (CONVNETS_TPU_DENSENET_FUSED=1) against the standard
     layout with the same weights: the fp32 b8 SGD step (loss, every
     gradient leaf beside the perturbed control, each bank's running
     statistics against the matching bn1's), the fp32 b8 eval logits, the
     fused model's kernel-vs-plain step check, a served b256 request's
     launches with no library convolution in it; (ii) bench.py's b256
     train step, standard and fused in turns: img/s, peak memory, launches
     per step (both 1 + 1 + 119 conv2d_fused + 1 + 3 + 4), device ms per
     step with the BN statistics and normalize passes split out; (iii)
     Remat on RN50 and the fused DN121 against no remat: the fp32 b8 SGD
     step (BN buffers bit for bit, gradients within the step bar, launches
     exactly the step's plus the recomputed forwards'; the fused DN121 also
     with dropout 0.5 inside the wrapped blocks, where a control whose
     recompute redraws its masks must fall outside the bar), then b256
     img/s and peak memory in turns; (iv) a replayed RN26@32 fit with
     remat=True over a DeviceCacheLoader against the per-step loop, phase
     13's protocol, launches per replay exact; (v) fit(debug=True) from a
     host DataLoader: one trace line per module that runs, before the first
     epoch, then a replayed epoch with no hook left; (vi) RN50 b256 steps
     from a host DataLoader (side-stream copies) against the same batches
     placed on the card first, bit for bit, and, under two profiles (CPU
     and CUDA activity; CUDA alone), the copies' streams, their overlap
     with kernels, the device's backlog as each copy was issued and the
     pinned allocations and host waits; (vii) nn.AdaptiveAvgPool2d
     (adaptive_avg_pool2d): one avg_pool2d launch per even call within
     row 3's bars, uneven bins against the CPU. Prints the
     last_modules JSON line.
  16. data parallel (convnets_tpu_torch/parallel) on the one card: (i) a
     world of one rank over NCCL: phase 13's replayed RN26@32 fit (2
     epochs) with Trainer(mesh=make_mesh()) against the same fit without a
     mesh, bit for bit (parameters, BN buffers, epoch losses and scores,
     evaluate's loss and predictions), 29 + 29 + 1 + 1 launches per
     replay, the all-reduces captured into the step (2 per BN layer, the
     gradient bucket, Σw) and none issued by a replay, img/s with and
     without the mesh in turns, the NCCL kernels of a profiled epoch; (ii)
     NCCL with two ranks on the card (expected refused), then two ranks
     that share the card over gloo: an fp32 global-b8 SGD step (2 × 4)
     against one process at b8 by phase 5 (i)'s bar beside its perturbed
     control, a no-sync control (one rank's half alone) outside the BN
     bar; RN50@224 with bench.py's settings at a global batch of 256, 10
     Adam steps: 53 + 53 + 1 + 1 launches per step on each rank, the
     replicas bit for bit after every step, the loss falls, the
     gloo-on-one-card img/s of steps 2-7; (iii) `torchrun --nproc-per-node
     1 -m convnets_tpu_torch fit` on phase 12's PNG tree (RN26, 1 epoch):
     exit 0, one checkpoint, exact launches per call (recorded inside the
     worker), its test argmax = an in-process Trainer.test's of the same
     checkpoint; (iv) dryrun_multichip(2, "cuda"). Prints the
     data_parallel JSON line.
  17. every conv the JAX package's Conv2d accepts (ROADMAP item 8: more
     than 64 groups, a stride of 3 or different strides per axis, a
     depthwise channel multiplier, a dilated depthwise conv): (i) the
     depthwise kernel at D1 (dilated 3x3 at 33², C 576 and 960: the vector
     route, torch.equal to the loop route), D2 (multiplier 2) and D3
     (dilated, multiplier 2), and the grouped kernels at G1 (128 groups,
     stride 1 and 2), G2 (256 groups, Cin/G 2), G3 (1x1, 128 groups) and G4
     (stride 3, stride (2, 1)), b8 fp32 and bf16 and b256 bf16, each against
     its plain version under phase 2/4's bars on the route its plan gives
     (counted), b256 timed beside cuDNN's F.conv2d and the bound; the
     trainable functions at four new shapes; (ii) a network built as
     template_net.py shows (build_envelope_net, registered for the phase
     only: Builder.conv_block layers, one of each kind, a BN site on each)
     through phase 12 (i)'s checks (fp32 b8 logits and SGD step against the
     plain path, ten bf16 Adam steps with a falling loss, exact launches per
     forward, step and route), a profiled b256 request with no library
     convolution, and its path: a bf16 b256 step and request with exact
     launches per kernel and route; (iii) its artifact served by a fresh
     process, argmax against the live model. Prints the envelope JSON
     line.
  18. the Winograd path (CONVNETS_TPU_WINOGRAD = 2 or 4: every dense 3x3
     stride-1 conv, bare or BN-fused, through csrc/winograd.cu's input and
     output transforms with the batched cuBLAS product between them): (i)
     at every such shape of RN50@224 and VGG-16@32 (Cin 3 included), m = 2
     and 4, b8 fp32 and bf16: the input kernel's V and the output kernel's
     three epilogues (bias; scale/shift/ReLU; y with Σy, Σy² of its own
     stored y) against their plain versions on the card (CONV_TOL,
     STATS_TOL), the whole conv against conv2d_fused within JAX's Winograd
     bars (fp32 max|Δ| / max|ref| ≤ 2e-5 / 3e-4; bf16 the error band of
     tests/test_winograd.py against the fp32 direct conv); RN50's four
     shapes at b256 bf16, the kernels first against their plain versions
     as at b8, then stage by stage beside conv2d_fused, cuDNN's F.conv2d
     and the bound, with the V and M temporaries' peak; (ii) RN50@224 bf16
     b256 with bench.py's settings, the gate off, 2, 4 in turns: launches
     per step (13 + 13 transform launches, 40 conv2d_stats, 53
     reductions) and per served request exact, a gated request's argmax =
     the plain path's on ≥ 0.99, img/s, peak memory and the profiled
     device ms per step; at each gate the fp32 b8 SGD step against the plain path
     beside the perturbed control and ten bf16 Adam steps with a falling
     loss; (iii) VGG-16@32 with gate 4 through the CLI on a phase 12 PNG
     tree: a 2-epoch fit with exact launches per call, the exported
     artifact's request (profiled: no library convolution) and a fresh
     process with the gate unset serving it, argmax = Trainer.test's on
     ≥ 0.99. Prints the winograd JSON line.
  19. the native image codec (convnets_tpu_torch/native: libpng, libjpeg
     and Pillow's BILINEAR resize in C++, built with g++ at first use) on
     the card's host: (i) whether it built (a build that fails for a
     missing png.h, jpeglib.h, -lpng or -ljpeg is reported with g++'s
     error and what the toolchain finds, and the data path then decodes
     with PIL; any other failure fails the phase); every image of phase
     12's PNG tree (3,840 at 32²) and of a JPEG tree written here (256 at
     500x375, quality 90, synthetic_dataset from --seed) through
     ImageFolderDataset with CONVNETS_TPU_NATIVE_DECODE on and off, at
     native size and the JPEGs also at 224²: the route counters exact
     (native.DECODES), the cache tags, the two routes within the CPU
     tests' bars (PNG bit for bit, JPEG mean |Δ| ≤ 1 per image); (ii)
     decode img/s on one thread and through the DataLoader at the CLI's 16
     threads (the PNG tree's valid split and the JPEG tree), the gate in
     turns (off, on, on, off; where the codec did not build both gates
     decode with PIL, and one turn of each runs), beside nproc; (iii)
     RN26@32 bf16 b256 fitted 2 epochs from a host DataLoader over the
     undecoded PNG tree (cache off), the gate in those turns from the same
     weights: exact launches per step and eval batch, every decode on its
     route, the fits' epoch losses bit for bit, epoch img/s and the
     device-idle share of each fit's last epoch (profiled). Prints the
     codec JSON line.
  20. the public API: (i) each family of FAMILIES, ZOO and ZOO2 at its
     kind and size (all sixteen registry names) built on the card, one
     bf16 b8 eval forward with a forward hook on every module of its
     Model.summary(batch_size=8): every line's printed output shape
     against what the module produced (a fused ConvBNReLU's conv, BN and
     ReLU, which its fused forward does not call, against the site's
     output), Model.out_shape(8) against the logits, Model.num_params()
     against the parameters' numel and the summary's total line, the
     forward's launches exact; (ii) a user's Builder network at 224²
     (build_public_net: the max-pool stem, ShuffleNet-v1-g4's widths 272 /
     544 / 1088, grouped (g = 4) conv_blocks, nn.ChannelShuffle, an
     nn.Concat of two b.conv(..., set_output=False) branches, a depthwise
     block, nn.Sigmoid; registered for the phase only): phase 14's fp32
     step check at b8, three bf16 Adam steps at b64 against the same
     network with its weights copied on the plain path (each loss within
     1e-2, the kernel path's falling, each step's launches and grouped
     routes exact: wgmma_wide), fp32 b8 eval logits against plain within
     1e-4 and a served bf16 b64 request's argmax against plain; (iii)
     ops.winograd.conv2d_winograd at RN50's 56²×64, b256 bf16, m = 4 and 2,
     against conv2d_winograd_plain within CONV_TOL and the fp32 direct conv
     within phase 18's band, timed beside the plain composition. Prints
     the public_api JSON line; the kernels line carries the path's
     launches as public_api_launches.
  --train-profile ROOT (no phases, no result line): RN50@224 bf16 b256's
     step ms and profiled device split (the fused sites' BN forward and
     backward apart, the backward nodes' kernels by name), RN26@32 b256's
     step img/s, the grouped conv_bn_relu_train sites' fwd+bwd ms (N=8,
     and b256 at ResNeXt-26@224's grouped shapes), and the world-of-one
     RN26@32 replayed fit with and without the mesh (img/s of epochs in
     turns, device events by name) of the checkout at ROOT; run over the
     parent and the change in turns.
  last lines: the card's name and power limit, the kernels JSON line (per
  kernel: launches on its main path and on phases 10-20's paths (PATHS),
  max error against the plain version,
  kernel, plain and library-call ms (device time, time_ms), and the bound: the larger of the
  bytes it must move over 3.35 TB/s and its operations over the peak rate
  of their type, 989 TFLOP/s for bf16 products, 67 TFLOP/s for other
  arithmetic), then {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

CONV_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (1e-2, 1e-2)}  # (atol, rtol)
# conv2d_stats sums: |Δ Σy| ≤ tol·Σ|y| and |Δ Σy²| ≤ tol·Σy² (fp32: summation
# order only; bf16: also y's one-ulp roundings where the accumulations differ)
STATS_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
# gradients, ‖Δ‖₂ / ‖g‖₂ per tensor. Where z rounds to ~0 on one path only,
# the ReLU mask flips and that element's whole cotangent moves: one flip
# shifts a conv gradient by several % of its largest element, so the
# max-based error (printed beside) cannot carry the check, while the L2
# error moves by ~1e-3 per flip. A wrong formula moves it by O(1).
GRAD_TOL = {"float32": 1e-2, "bfloat16": 5e-2}
# the whole fp32 step at init is ill-conditioned: the plain path against
# itself with its conv weights perturbed by 1e-7 relative (the "control",
# run beside the check) differs by ~2e-2 per gradient leaf in L2 for RN50;
# the bar sits above that, far below the O(1) of a wrong formula
STEP_GRAD_TOL = 0.1
CONTROL_PERTURBATION = 1e-7
POOL_TOL = 0.0  # a max of the same values is exact in either dtype
# avg pool: fp32 max|Δ| / max|ref| (only the fp32 summation order may
# differ); bf16: one ulp of each element (both round the same fp32 sum)
AVG_POOL_TOL = 1e-6
ARGMAX_MIN = 0.99
SERVE_BATCHES = (1, 8, 64)  # RN50
ZOO_SERVE_BATCHES = (8, 64)  # MobileNet-v1, DenseNet-121, ResNeXt-26
THROUGHPUT_BATCHES = {"resnet": (64, 256), "mobilenet_v1": (64, 256), "densenet": (256,),
                      "resnext": (256,)}
IMAGENET_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
REPS = 10  # timed launches per kernel measurement
IMAGE = 224
KERNEL_BATCH = 8
STEP_BATCH = 8  # phases 5 (i), 7 (i)
LEARN_BATCH, LEARN_STEPS = 32, 10  # phases 5 (ii), 7 (ii), 9 (ii)
# (ii)'s Adam learning rate. ResNeXt's classifier reads 100,352 non-negative
# features (no global pool): an Adam step moves each weight by ~lr, so each
# logit by ~lr·Σx, which at 1e-3 is tens of logits per step and the loss
# climbs after three steps on both paths; the others read ≤ 2048.
LEARN_LR = {"resnet": 1e-3, "mobilenet_v1": 1e-3, "densenet": 1e-3, "resnext": 1e-4}
# (ii)'s BN running statistics are brought to its batch's by zero-lr steps
# with every BN's momentum set to SETTLE_MOMENTUM: at 1 a single step sets
# them to that batch's statistics exactly. At the layers' own 0.1 a step
# leaves 0.9^k of the initial running var (~1), which must be small beside a
# layer's true var: MobileNet's depthwise outputs (He fan-out init, std
# sqrt(2/(9C))) have var far below 1, and after 40 such steps the 1.5% left
# over dominated them and eval mode served every image as one class (train
# mode had learned all 32).
SETTLE_STEPS, SETTLE_MOMENTUM = 1, 1.0
# the b256 train turns' depth, (warm-up, timed) steps a run: bench.py's
# protocol is 5 + 20; cut to 2 + 8 (phase 7 (iv)'s DN121 to 2 + 4) to hold
# the whole run inside its time limit once phase 16 was added (~120 s), to
# 2 + 6 once phase 17 was added
WARMUP, TIMED = 2, 6
DN121_TURNS = (2, 4)
# bench.py's batch per family (its first choice, 256, fits on an 80 GB card
# for all three: RN50 13.5 GiB, PERF.md §6; bench.py falls back to 128, 64)
TRAIN_BATCH = {"resnet": 256, "mobilenet_v1": 256, "densenet": 256, "resnext": 256}
NOBN_BATCH = 32  # phases 5 (iv), 9 (v)
FAMILIES = {"resnet": "50", "mobilenet_v1": "v1", "densenet": "121", "resnext": "26"}
# phases 8 and 8b: the grouped kernels at ResNeXt-50's grouped shapes (7
# shapes, 16 layers), whatever depth phase 9 runs
GROUPED_SHAPES_KIND, GROUPED_SHAPES_LAYERS = "50", 16
# kernel launches per forward (serving) and per train step, per family
SERVE_LAUNCHES = {
    "resnet": {"conv2d_fused": 53, "max_pool2d": 1},
    "mobilenet_v1": {"conv2d_fused": 14, "depthwise_conv2d": 13},
    "densenet": {"conv2d_fused": 120, "max_pool2d": 1, "avg_pool2d": 3},
    "resnext": {"conv2d_fused": 21, "grouped_conv2d_fused": 8, "max_pool2d": 1},
}
# the BN passes of the fused conv sites (conv_bn_relu_train, csrc/bn_act.cu):
# one forward launch per site, three backward launches (partial sums, their
# reduction, the apply pass)
BN_ACT_BACKWARD = ("bn_act_backward_sums", "bn_act_backward_reduce", "bn_act_backward_apply")


def bn_sites(n: int, backward: bool = True) -> dict:
    """The BN-pass launches of n fused conv sites: bn_act_forward each and,
    with the backward, its three launches each."""
    return {"bn_act_forward": n, **(dict.fromkeys(BN_ACT_BACKWARD, n) if backward else {})}


TRAIN_LAUNCHES = {
    "resnet": {"conv2d_stats": 53, "conv2d_stats_reduce": 53, "max_pool2d": 1,
               "pool2d_backward": 1, **bn_sites(53)},
    "mobilenet_v1": {"conv2d_stats": 14, "conv2d_stats_reduce": 14, "depthwise_conv2d": 13,
                     **bn_sites(14)},
    "densenet": {"conv2d_stats": 1, "conv2d_stats_reduce": 1, "conv2d_fused": 119,
                 "max_pool2d": 1, "avg_pool2d": 3, "pool2d_backward": 4, **bn_sites(1)},
    "resnext": {"conv2d_stats": 21, "grouped_conv2d_stats": 8, "conv2d_stats_reduce": 29,
                "max_pool2d": 1, "pool2d_backward": 1, **bn_sites(29)},
}
# the window kernels, whose route (vector or loop) is chosen by shape: on
# every family's paths each launch must take the vector route
WINDOW_ROUTED = ("depthwise_conv2d", "max_pool2d", "avg_pool2d", "pool2d_backward")
OUR_KERNELS = ("conv_wgmma_kernel<", "conv_kernel<", "stats_reduce_kernel", "pool_vec_kernel<",
               "pool_bwd_kernel<", "depthwise_kernel<", "depthwise_vec_kernel<",
               "grouped_conv_kernel<", "grouped_wide_kernel<", "bottleneck_kernel<",
               "bn_act_forward_kernel<", "bn_act_sums_kernel<", "bn_act_apply_kernel<",
               "winograd_input_kernel<", "winograd_output_kernel<")
# the window kernels as the profiler names them, for their share of a
# request's or a step's device time
WINDOW_KERNELS = (("depthwise", ("depthwise_kernel<", "depthwise_vec_kernel<")),
                  ("pool", ("pool_vec_kernel<", "pool_bwd_kernel<")))
# the grouped conv's kernels as the profiler names them: the grouped mode of
# conv_wgmma_kernel<64, STATS, true, CG>, the wide route's
# grouped_wide_kernel<NW, STATS> and the CUDA-core loop
GROUPED_KERNELS = tuple(f"conv_wgmma_kernel<64, {st}, true, {cg}>" for st in ("false", "true")
                        for cg in (4, 8, 16, 32)) + ("grouped_wide_kernel<", "grouped_conv_kernel<")
# the grouped conv wrappers, whose launches ROUTE_LAUNCHES also counts per route
GROUPED_ROUTED = ("grouped_conv2d_fused", "grouped_conv2d_stats")
# phase 2a: every branch of conv_plan, (N, H, W, Cin, Cout, k, stride, pad, what)
PLAN_SHAPES = (
    (1, 224, 224, 3, 64, 7, 2, 3, "7x7x3 stem at N=1 (scalar gather, K=147)"),
    (2, 224, 224, 3, 32, 3, 2, 1, "3x3x3 stem (scalar gather, K=27, BN 32)"),
    (8, 56, 56, 12, 256, 3, 1, 1, "Cin=12 (scalar gather, BN 128)"),
    (2, 14, 14, 12, 64, 3, 1, 1, "Cin=12 (scalar gather, BN 64)"),
    (2, 28, 28, 128, 32, 3, 1, 1, "Cout=32 (BN 32)"),
    (2, 14, 14, 64, 24, 3, 1, 1, "Cout=24 (scalar B load, one ragged tile)"),
    (2, 14, 14, 64, 27, 3, 1, 1, "Cout=27 (odd: single-value stores)"),
    (2, 28, 28, 256, 512, 1, 2, 0, "1x1 stride 2 p0"),
    (2, 14, 14, 40, 64, 1, 1, 0, "Cin=40 (K=40 < 64)"),
    (1, 7, 7, 512, 2048, 1, 1, 0, "M=49 < BM"),
    (256, 56, 56, 64, 64, 3, 1, 1, "RN50 b256 3x3 (BN 64)"),
    (256, 14, 14, 256, 1024, 1, 1, 0, "RN50 b256 1x1 (BN 128)"),
)
# phase 8: every branch of grouped_plan, (N, H, W, Cin, Cout, G, k, stride,
# pad, bf16 route, what); fp32 always takes "simt"
GROUPED_PLAN_SHAPES = (
    (1, 7, 7, 128, 128, 32, 3, 1, 1, "wgmma", "Cin/G=4 at N=1 (M=49 < BM)"),
    (1, 7, 7, 256, 256, 32, 3, 1, 1, "wgmma", "Cin/G=8 at N=1"),
    (1, 7, 7, 512, 512, 32, 3, 1, 1, "wgmma", "Cin/G=16 at N=1"),
    (1, 7, 7, 1024, 1024, 32, 3, 1, 1, "wgmma", "Cin/G=32 at N=1"),
    (2, 15, 15, 128, 128, 32, 3, 2, 1, "wgmma", "Cin/G=4 stride 2, odd input"),
    (2, 14, 14, 256, 256, 8, 3, 2, 1, "wgmma", "Cin/G=32, G=8, stride 2"),
    (2, 16, 16, 256, 256, 16, 3, 1, 0, "wgmma", "Cin/G=16, 3x3 p0"),
    (2, 14, 14, 128, 128, 16, 1, 1, 0, "wgmma", "1x1 Cin/G=8 (KT=1 < ring slots)"),
    (2, 14, 14, 64, 64, 32, 3, 1, 1, "simt", "Cin/G=2 (bf16 simt)"),
    (2, 14, 14, 128, 256, 32, 3, 1, 1, "wgmma_wide", "Cout/G=8 != Cin/G=4, 3x3, 8 groups a tile"),
    (2, 15, 15, 68, 248, 4, 3, 2, 1, "wgmma_wide", "odd Cin/G=17 (2-byte gather), 3x3 s2"),
    (3, 9, 9, 200, 600, 2, 1, 1, 0, "wgmma_wide", "Cout/G=300: three pieces; 8-byte copies"),
    (1, 5, 5, 96, 96, 24, 3, 1, 1, "wgmma_wide", "Cin=96, G=24 (Cin % 64 != 0), N=1"),
    (2, 7, 7, 130, 90, 2, 3, 1, 1, "wgmma_wide", "odd Cin/G=65 over two stages, Cout/G=45"),
)
B256 = 256  # phases 4b, 8b: rows 1, 5 (RN50) and 1g, 5g (ResNeXt-50) at this batch
B256_KEYS = ("ms_b256", "library_ms_b256", "bound_ms_b256")
# rows 1g, 5g and 8 also carry the CUDA-core grouped loop's times (phases 8,
# 8b), row 10 its CUDA-core route's b256 time (phase 8)
SIMT_KEYS = ("simt_ms", "simt_ms_b256")
# rows 2, 3, 4 and 9 also carry their plain version's time at b256, rows 2,
# 3 and 9 their loop route's (phase 6b)
PLAIN_B256, LOOP_B256 = "plain_ms_b256", "loop_ms_b256"
# the block A/B of scripts/tpu_block_ab.py: (H, Cin, Cmid, blocks RN50 chains there)
BLOCK_SHAPES = ((14, 1024, 256, 6), (28, 512, 128, 4))
BLOCK_BATCH = 256
# phase 8's block checks at N=8: RN50's three identity shapes (H, Cin, Cmid),
# all on the wgmma route in bf16, and a bf16 shape off it (Cmid = 32)
BLOCK_CHECK_SHAPES = ((56, 256, 64), (28, 512, 128), (14, 1024, 256))
BLOCK_SIMT_SHAPE = (14, 256, 32)
# bottleneck_block vs its plain version: fp32 sums in another order; bf16
# also h1/h2 roundings one ulp apart (the bar of tests/test_block_kernel.py)
BLOCK_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (5e-2, 5e-2)}
# the bound of a kernel: the H100 SXM's published peaks at 700 W: bf16
# tensor-core products, other arithmetic at the fp32 CUDA-core rate, device
# memory
PEAK_BF16 = 989e12
PEAK_OTHER = 67e12
HBM_BPS = 3.35e12
DEVICE = "cuda"


def say(*args):
    print(*args, flush=True)


def die(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sync():
    import torch

    torch.cuda.synchronize()


_SLEEP_CYCLES_PER_S = []


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events).
    A device-side sleep queued first, about 1.5× the host time the calls
    take to enqueue (at least 1 ms, at most 0.2 s), lets the host queue
    them all before the first starts, so a call that the host launches
    more slowly than the card runs it (the wrappers at N=8) is timed on the
    card, not at the host's pace; the garbage collector is held off while
    they are queued, so none of its pauses lands between two calls."""
    import gc

    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not _SLEEP_CYCLES_PER_S:  # the sleep's clock, once
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_S.append(1e7 / (start.elapsed_time(end) / 1e3))
    fn()
    sync()
    t0 = time.perf_counter()
    fn()  # the host time of one call
    host = time.perf_counter() - t0
    sync()
    collecting = gc.isenabled()
    gc.disable()
    try:
        torch.cuda._sleep(int(_SLEEP_CYCLES_PER_S[0] * min(0.2, max(1e-3, 1.5 * reps * host))))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    finally:
        if collecting:
            gc.enable()
    end.synchronize()
    return start.elapsed_time(end) / reps


def launches_of(counts: dict) -> dict:
    """A full LAUNCHES dict: `counts`, zero for every other kernel."""
    from convnets_tpu_torch.ops import kernels

    return {k: counts.get(k, 0) for k in kernels.LAUNCHES}


def check_routes(what, launches, failures):
    """Each launch of a window kernel (WINDOW_ROUTED) in a run took the
    vector route: the run's ROUTE_LAUNCHES against its LAUNCHES."""
    from convnets_tpu_torch.ops import kernels

    routes = {k: dict(kernels.ROUTE_LAUNCHES[k]) for k in WINDOW_ROUTED}
    off = [k for k, r in routes.items() if r["loop"] or r["vector"] != launches[k]]
    say(f"{what}: window kernel launches, vector / loop route: "
        + ", ".join(f"{k} {r['vector']} / {r['loop']}" for k, r in routes.items())
        + (" ok" if not off else " FAIL"))
    if off:
        failures.append(f"{what}: window kernels off the vector route: {routes}")


def model_layers(model, with_dilation=False, inside_remat=False):
    """(kind, H, W, Cin, Cout, k, stride, pad, relu, groups[, dilation]) of
    every conv and pool of the model (stride a pair where it differs per
    axis), in forward order, from its own
    modules (SKConv's paths, descriptor and attention convs at their 1x1
    input, ShuffleUnit's convs and the pool of its identity among them,
    DenseBlockFused's convs). kind: "conv" (a fused ConvBNReLU), "gconv" (a
    grouped one), "dwconv" (a depthwise one), "plainconv" / "plaingconv" /
    "plaindwconv" (a Conv2d outside a ConvBNReLU), "maxpool", "avgpool".
    inside_remat: only those under a Remat (what its recompute runs)."""
    from convnets_tpu_torch import nn
    from convnets_tpu_torch.models.blocks import SKConv
    from convnets_tpu_torch.models.densenet import DenseBlockFused
    from convnets_tpu_torch.models.shufflenet_v1 import ShuffleUnit

    out, remat = [], []

    def conv(kind, c, shape, relu):
        if inside_remat and not remat:
            return
        if c.groups > 1:
            kind = kind[:-4] + ("dwconv" if c.groups == shape[3] else "gconv")
        stride = c.stride[0] if c.stride[0] == c.stride[1] else tuple(c.stride)
        out.append((kind, shape[1], shape[2], shape[3], c.out_channels, c.kernel[0],
                    stride, c.padding[0], relu, c.groups, c.dilation[0]))

    def walk(mod, shape):
        if isinstance(mod, nn.ConvBNReLU):
            conv("conv", mod._modules["0"], shape, mod.act)
        elif isinstance(mod, nn.Conv2d):
            conv("plainconv", mod, shape, False)
        elif isinstance(mod, DenseBlockFused):
            for i in range(mod.size):
                c1 = mod._modules[f"conv1_{i}"]
                conv("plainconv", c1, (*shape[:3], mod.c0 + i * mod.growth), False)
                conv("plainconv", mod._modules[f"conv2_{i}"], (*shape[:3], c1.out_channels),
                     False)
        elif isinstance(mod, (nn.MaxPool2d, nn.AvgPool2d)):
            if inside_remat and not remat:
                return
            kind = "maxpool" if isinstance(mod, nn.MaxPool2d) else "avgpool"
            stride = mod.kernel if mod.stride is None else mod.stride
            out.append((kind, shape[1], shape[2], shape[3], shape[3], mod.kernel, stride,
                        mod.padding, False, 1, 1))
        elif isinstance(mod, (nn.Add, nn.Concat)):
            for branch in mod._modules.values():
                walk(branch, shape)
        elif isinstance(mod, SKConv):
            for path in mod._paths():
                walk(path, shape)
            walk(mod.descriptor, (shape[0], 1, 1, mod.channels))
            for att in mod._attentions():
                walk(att, (shape[0], 1, 1, mod.desc_size))
        elif isinstance(mod, ShuffleUnit):
            inner = shape
            for child in (mod.compress, mod.depthwise, mod.expand):
                walk(child, inner)
                inner = child.out_shape(inner)
            if mod.pool is not None:
                walk(mod.pool, shape)
        elif isinstance(mod, nn.Sequential):
            for child in mod._modules.values():
                walk(child, shape)
                shape = child.out_shape(shape)
        elif isinstance(mod, nn.Remat):
            remat.append(mod)
            walk(mod.child, shape)
            remat.pop()

    walk(model.module, model.batch_shape(1))
    return out if with_dilation else [layer[:-1] for layer in out]


def distinct_shapes(model, kinds=("conv",)):
    """{(H, W, Cin, Cout, k, stride, pad, groups): [relu flag of each layer]}
    (of the families before phase 14, whose convs are all undilated)."""
    distinct = {}
    for _, h, w, cin, cout, k, s, p, relu, g in (l for l in model_layers(model)
                                                 if l[0] in kinds):
        distinct.setdefault((h, w, cin, cout, k, s, p, g), []).append(relu)
    return distinct


def conv_work(n, h, w, cin, cout, k, s, p, groups=1, itemsize=2, dilation=1):
    """(FLOPs, bytes) of one conv call: 2·M·(k²·Cin/G)·Cout multiply-adds,
    and x and w read once, y written once, in the dtype of `itemsize`; s
    an int or a pair (sh, sw)."""
    from convnets_tpu_torch.core.shapes import conv_out_size

    sh, sw = (s, s) if isinstance(s, int) else s
    oh, ow = conv_out_size(h, k, sh, p, dilation), conv_out_size(w, k, sw, p, dilation)
    flops = 2 * n * oh * ow * cout * k * k * (cin // groups)
    return flops, itemsize * (n * h * w * cin + k * k * (cin // groups) * cout + n * oh * ow * cout)


def forward_gflop(model) -> float:
    """Multiply-adds ×2 of the model's convs per image, counted from its
    modules (the pools, BN and the linear add < 0.1%, except ResNeXt's
    100,352 → 1000 classifier, which forward_linear_gflop counts)."""
    total = 0
    for kind, h, w, cin, cout, k, s, p, _, g, d in model_layers(model, with_dilation=True):
        if not kind.endswith("pool"):
            total += conv_work(1, h, w, cin, cout, k, s, p, g, dilation=d)[0]
    return total / 1e9


def forward_linear_gflop(model) -> float:
    """2·in·out of the model's classifier per image."""
    from convnets_tpu_torch import nn

    return sum(2 * m.weight.numel() for m in model.modules() if isinstance(m, nn.Linear)) / 1e9


def entry(summary, name):
    """A kernel's row of the JSON line: max error, the kernel's, plain
    version's and library call's ms, and its bound, each summed over the
    calls added to it."""
    return summary.setdefault(name, {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None,
                                     "bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0})


def add_times(row, uses, k_ms, p_ms, flops, nbytes, lib_ms=None, peak=PEAK_BF16):
    """Add `uses` calls of one shape to a row: measured ms, and the bound
    max(flops / peak, bytes / HBM) of each call."""
    ops_ms, bytes_ms = 1e3 * flops / peak, 1e3 * nbytes / HBM_BPS
    row["ms"] += uses * k_ms
    row["plain_ms"] += uses * p_ms
    row["ops_ms"] += uses * ops_ms
    row["bytes_ms"] += uses * bytes_ms
    row["bound_ms"] += uses * max(ops_ms, bytes_ms)
    if lib_ms is not None:
        row["library_ms"] = (row["library_ms"] or 0.0) + uses * lib_ms


def nchw(t):
    """The NCHW view of an NHWC tensor (channels_last in memory), as cuDNN
    and F's pools take it."""
    return t.permute(0, 3, 1, 2)


def oihw(w):
    """An HWIO weight as a channels_last OIHW tensor."""
    import torch

    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def random_jax_variables(model, seed: int, conv_gain=None) -> dict:
    """numpy weights in the tree convnets_tpu's init produces for this model
    (HWIO conv w, (in, out) linear w, BN params/state), drawn from `seed`.
    conv_gain: conv std gain·sqrt(2 / fan_in) instead of He fan-out, for a
    net without BN, whose activations He init lets grow past bf16's range."""
    from convnets_tpu_torch import bridge

    rng = np.random.default_rng(seed)
    tree = {"params": {}, "state": {}}
    for path, (mod, tname) in sorted(bridge.jax_layout(model).items()):
        shape = tuple(getattr(mod, tname).shape)
        leaf = path[-1]
        if leaf == "w" and len(shape) == 4:
            kh, kw, i, o = shape
            fan = o * kh * kw if conv_gain is None else i * kh * kw
            v = rng.standard_normal(shape) * (conv_gain or 1.0) * np.sqrt(2.0 / fan)
        elif leaf == "w":
            v = rng.standard_normal(shape) * 0.01
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.8, 1.2, shape)
        else:  # BN bias / mean, linear bias
            v = rng.standard_normal(shape) * 0.05
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = v.astype(np.float32)
    return tree


PLAIN = {"conv2d_fused": "conv2d_fused_plain", "conv2d_stats": "conv2d_stats_plain",
         "max_pool2d": "max_pool2d_plain", "avg_pool2d": "avg_pool2d_plain",
         "pool2d_backward": "pool2d_backward_plain",
         "depthwise_conv2d": "depthwise_conv2d_plain",
         "grouped_conv2d_fused": "grouped_conv2d_fused_plain",
         "grouped_conv2d_stats": "grouped_conv2d_stats_plain",
         "bottleneck_block": "bottleneck_block_plain",
         "bn_act_forward": "bn_act_forward_plain", "bn_act_backward": "bn_act_backward_plain",
         "winograd_conv2d": "winograd_conv2d_plain",
         "winograd_conv2d_stats": "winograd_conv2d_stats_plain"}


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel call of the model (and of the trainable functions,
    which call the wrappers through the kernels package) to the plain
    PyTorch versions, for the on-card comparison only; the package itself
    never does this."""
    from convnets_tpu_torch.ops import kernels

    saved = {name: getattr(kernels, name) for name in PLAIN}
    for name, plain in PLAIN.items():
        setattr(kernels, name, getattr(kernels, plain))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


def within(got, ref, atol, rtol) -> bool:
    return bool(((got.float() - ref.float()).abs() <= atol + rtol * ref.float().abs()).all())


def dname_of(dtype) -> str:
    return str(dtype).split(".")[-1]


def phase_kernels(model, failures):
    """Kernel vs plain at every distinct RN50@224 conv shape and the stem
    pool, batch 8. Returns the per-kernel summary for the JSON line."""
    import torch
    import torch.nn.functional as F

    from convnets_tpu_torch.ops import kernels

    layers = model_layers(model)
    convs = [l for l in layers if l[0] == "conv"]
    pools = [l for l in layers if l[0] == "maxpool"]
    want = SERVE_LAUNCHES["resnet"]
    if len(convs) != want["conv2d_fused"] or len(pools) != want["max_pool2d"]:
        failures.append(f"RN50 walk found {len(convs)} convs, {len(pools)} pools")
    distinct = distinct_shapes(model)

    g = torch.Generator(device=DEVICE).manual_seed(0)
    n = KERNEL_BATCH
    summary = {}
    conv_row, pool_row = entry(summary, "conv2d_fused"), entry(summary, "max_pool2d")
    say("conv shapes (N=8): H W Cin Cout k s p | dtype relu | max_abs_err tol | "
        "kernel_ms plain_ms cudnn_bf16_ms | uses")
    for (h, w, cin, cout, k, s, p, _), relus in sorted(distinct.items()):
        x32 = torch.randn(n, h, w, cin, device=DEVICE, generator=g)
        w32 = torch.randn(k, k, cin, cout, device=DEVICE, generator=g) / np.sqrt(k * k * cin)
        scale = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        shift = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            x, wt = x32.to(dtype).contiguous(), w32.to(dtype).contiguous()
            dname = dname_of(dtype)
            atol, rtol = CONV_TOL[dname]
            # the same conv through cuDNN in bf16 (channels_last): the
            # library time, not a contract check
            xc, wc = nchw(x32.to(torch.bfloat16)), oihw(w32.to(torch.bfloat16))
            cudnn_ms = time_ms(lambda: F.conv2d(xc, wc, stride=s, padding=p), REPS)
            for relu in (False, True):
                args = (x, wt, scale, shift)
                kw = dict(stride=s, padding=p, relu=relu)
                got = kernels.conv2d_fused(*args, **kw)
                ref = kernels.conv2d_fused_plain(*args, **kw)
                sync()
                err = float((got.float() - ref.float()).abs().max())
                ok = within(got, ref, atol, rtol) and bool(torch.isfinite(got).all())
                k_ms = time_ms(lambda: kernels.conv2d_fused(*args, **kw), REPS)
                p_ms = time_ms(lambda: kernels.conv2d_fused_plain(*args, **kw), REPS)
                uses = relus.count(relu)
                say(f"  {h} {w} {cin} {cout} {k} {s} {p} | {dname} {int(relu)} | "
                    f"{err:.3e} {atol:g}+{rtol:g}|ref| {'ok' if ok else 'FAIL'} | "
                    f"{k_ms:.4f} {p_ms:.4f} {cudnn_ms:.4f} | {uses}")
                if not ok:
                    failures.append(f"conv {h}x{w} {cin}->{cout} k{k} s{s} {dname} relu={relu}: "
                                    f"err {err:.3e}")
                conv_row["err"] = max(conv_row["err"], err)
                if dtype == torch.bfloat16:
                    flops, nbytes = conv_work(n, h, w, cin, cout, k, s, p)
                    add_times(conv_row, uses, k_ms, p_ms, flops, nbytes + 8 * cout, cudnn_ms)

    _, h, w, c, _, k, s, p, _, _ = pools[0]
    x32 = torch.randn(n, h, w, c, device=DEVICE, generator=g)
    say("stem max-pool (N=8): H W C k s p | dtype | max_abs_err | kernel_ms plain_ms "
        "F.max_pool2d_ms")
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        got = kernels.max_pool2d(x, k, s, p)
        ref = kernels.max_pool2d_plain(x, k, s, p)
        sync()
        err = float((got.float() - ref.float()).abs().max())
        ok = got.shape == ref.shape and err <= POOL_TOL
        k_ms = time_ms(lambda: kernels.max_pool2d(x, k, s, p), REPS)
        p_ms = time_ms(lambda: kernels.max_pool2d_plain(x, k, s, p), REPS)
        lib_ms = time_ms(lambda: F.max_pool2d(nchw(x), k, s, p), REPS)
        dname = dname_of(dtype)
        say(f"  {h} {w} {c} {k} {s} {p} | {dname} | {err:.3e} {'ok' if ok else 'FAIL'} | "
            f"{k_ms:.4f} {p_ms:.4f} {lib_ms:.4f}")
        if not ok:
            failures.append(f"max_pool2d {dname}: err {err:.3e}")
        pool_row["err"] = max(pool_row["err"], err)
        if dtype == torch.bfloat16:
            add_times(pool_row, 1, k_ms, p_ms, k * k * got.numel(),
                      2 * (x.numel() + got.numel()), lib_ms, PEAK_OTHER)
    say(f"RN50 conv layers at N=8 bf16, summed over the 53 layers: kernel "
        f"{conv_row['ms']:.3f} ms, plain {conv_row['plain_ms']:.3f} ms, cuDNN bf16 "
        f"{conv_row['library_ms']:.3f} ms, bound {conv_row['bound_ms']:.4f} ms")
    return summary


def model_setting(arch, seed, mixed, **kw):
    from convnets_tpu_torch.settings import Settings

    fields = dict(kind=FAMILIES[arch], input_size=(3, IMAGE, IMAGE), num_classes=1000,
                  batch_norm=True, init_params=True, dropout_rate=0.5, mixed_precision=mixed,
                  seed=seed, learning_rate=0.01, weight_decay=1e-4, optimizer="adam")
    fields.update(kw)
    return Settings(**fields)


def make_model(arch, seed, mixed, conv_gain=None, **kw):
    """The family's model at 224² on the card, numpy weights from `seed`
    loaded by the bridge."""
    from convnets_tpu_torch import bridge
    from convnets_tpu_torch.models import build_model

    model = build_model(arch, model_setting(arch, seed, mixed, **kw), device=DEVICE)
    bridge.load_jax_variables(model, random_jax_variables(model, seed, conv_gain))
    return model


def rel_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-30))


def l2_err(got, ref) -> float:
    return float((got.float() - ref.float()).norm() / ref.float().norm().clamp_min(1e-30))


def check_trainable(name, label, fn, args, dname, g, summary, failures, out_tol,
                    work=(0, 0), lib=None, peak=PEAK_BF16):
    """Forward and every gradient of fn(*args), the kernel path against the
    same function with the plain versions swapped in; fwd+bwd times, and
    those of `lib` (the same function as one PyTorch call, NHWC in and out)
    where there is one. work: (FLOPs, bytes) of one fwd+bwd in bf16."""
    import torch

    cot = None

    def run(f=fn):
        nonlocal cot
        ins = [a.detach().clone().requires_grad_() for a in args]
        out = f(*ins)
        if cot is None or cot.shape != out.shape:
            cot = torch.randn(out.shape, device=DEVICE, generator=g).to(out.dtype)
        return [out.detach(), *torch.autograd.grad(out, ins, cot)]

    got = run()
    with plain_kernels():
        ref = run()
    sync()
    out_err = rel_err(got[0], ref[0])
    grad_l2 = [l2_err(a, b) for a, b in zip(got[1:], ref[1:])]
    grad_max = [rel_err(a, b) for a, b in zip(got[1:], ref[1:])]
    flips = int(((got[0] > 0) != (ref[0] > 0)).sum())
    ok = (out_err <= out_tol and max(grad_l2) <= GRAD_TOL[dname]
          and all(bool(torch.isfinite(t).all()) for t in got))
    k_ms = time_ms(run, 3)
    with plain_kernels():
        p_ms = time_ms(run, 3)
    lib_ms = None if lib is None else time_ms(lambda: run(lib), 3)
    say(f"  {name} {label} | {dname} | {out_err:.2e} ({out_tol:g}) | "
        f"{' '.join(f'{e:.2e}' for e in grad_l2)} ({GRAD_TOL[dname]:g}) "
        f"[{' '.join(f'{e:.1e}' for e in grad_max)}] | {flips} {'ok' if ok else 'FAIL'} | "
        f"{k_ms:.4f} {p_ms:.4f} {'-' if lib_ms is None else f'{lib_ms:.4f}'}")
    if not ok:
        failures.append(f"{name} {label} {dname}: out {out_err:.2e}, gradients {grad_l2}")
    row = entry(summary, name)
    row["err"] = max(row["err"], max(float((a.float() - b.float()).abs().max())
                                     for a, b in zip(got, ref)))
    if dname == "bfloat16":
        add_times(row, 1, k_ms, p_ms, *work, lib_ms, peak)


def conv_train_work(n, h, w, cin, cout, k, s, p, groups=1, dilation=1):
    """(FLOPs, bytes) of a bf16 conv's fwd+bwd: three products (y, dx, dw);
    x, w and the cotangent read, y, dx and dw written."""
    flops, nbytes = conv_work(n, h, w, cin, cout, k, s, p, groups, dilation=dilation)
    return 3 * flops, 2 * nbytes


def conv_lib(s, p, groups=1, dilation=1):
    """F.conv2d (cuDNN on the card) on NHWC x and HWIO w, NHWC out."""
    import torch.nn.functional as F

    return lambda a, b: F.conv2d(nchw(a), b.permute(3, 2, 0, 1), stride=s, padding=p,
                                 dilation=dilation, groups=groups).permute(0, 2, 3, 1)


def pool_lib(mode, k, s, p):
    """F.max_pool2d / F.avg_pool2d on NHWC x, NHWC out."""
    import torch.nn.functional as F

    pool = F.max_pool2d if mode == "max" else F.avg_pool2d
    return lambda a: pool(nchw(a), k, s, p).permute(0, 2, 3, 1)


def conv_out_size(size, k, s, p, d=1):
    from convnets_tpu_torch.core.shapes import conv_out_size as out

    return out(size, k, s, p, d)


def stats_check(got, ref, dname, own=False):
    """(ok, y max|Δ|, Σ error, Σ² error) of conv2d_stats' (y, [Σy; Σy²])
    against its plain version: y within CONV_TOL, |ΔΣ| / max Σ|y| and
    |ΔΣ²| / Σ² within STATS_TOL. own: the sums against those of the
    kernel's own stored y (the epilogue's contract), for shapes with so few
    rows per channel that y's one-ulp roundings alone move Σ² past the bar
    (at M = 49 one bf16 ulp of the largest of 49 values moves Σ² by up to
    2·2⁻⁸·max y² / Σy², ~2e-3); y is still held to the plain version."""
    import torch

    (y, (s1, s2)), (ry, (r1, r2)) = got, ref
    sync()
    atol, rtol = CONV_TOL[dname]
    err = float((y.float() - ry.float()).abs().max())
    y_ok = within(y, ry, atol, rtol)
    if own:
        ry, yf = y, y.float()
        r1, r2 = yf.sum(dim=(0, 1, 2)), (yf * yf).sum(dim=(0, 1, 2))
    e1 = float((s1 - r1).abs().max() / ry.float().abs().sum(dim=(0, 1, 2)).max().clamp_min(1e-30))
    e2 = float(((s2 - r2).abs() / r2.clamp_min(1e-30)).max())
    ok = y_ok and max(e1, e2) <= STATS_TOL[dname] and bool(torch.isfinite(s2).all())
    return ok, err, e1, e2


def phase_conv_plans(failures):
    """Phase 2a: every branch of conv_plan (PLAN_SHAPES) against the plain
    versions, fp32 and bf16, both epilogues: y without and with
    scale/shift/ReLU; y, Σy, Σy² (the sums against those of the kernel's
    own stored y, see stats_check)."""
    import torch

    from convnets_tpu_torch.ops import kernels

    g = torch.Generator(device=DEVICE).manual_seed(6)
    say("conv plans: N H W Cin Cout k s p | dtype plan | fused y err, relu=0 / 1 (tol) | "
        "stats y err, Σ rel, Σ² rel (tol) | what")
    for n, h, w, cin, cout, k, s, p, what in PLAN_SHAPES:
        x32 = torch.randn(n, h, w, cin, device=DEVICE, generator=g)
        w32 = torch.randn(k, k, cin, cout, device=DEVICE, generator=g) / np.sqrt(k * k * cin)
        scale = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        shift = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        m = n * conv_out_size(h, k, s, p) * conv_out_size(w, k, s, p)
        for dtype in (torch.float32, torch.bfloat16):
            dname = dname_of(dtype)
            atol, rtol = CONV_TOL[dname]
            x, wt = x32.to(dtype), w32.to(dtype)
            plan = kernels.conv_plan(dtype, m, cin, cout)
            errs, ok = [], plan.route == ("wgmma" if dtype == torch.bfloat16 else "simt")
            for epi in (None, (scale, shift)):
                kw = dict(stride=s, padding=p, relu=epi is not None)
                got = kernels.conv2d_fused(x, wt, *(epi or ()), **kw)
                ref = kernels.conv2d_fused_plain(x, wt, *(epi or ()), **kw)
                sync()
                errs.append(float((got.float() - ref.float()).abs().max()))
                ok = ok and within(got, ref, atol, rtol) and bool(torch.isfinite(got).all())
                del got, ref
            kw = dict(stride=s, padding=p)
            s_ok, y_err, e1, e2 = stats_check(kernels.conv2d_stats(x, wt, **kw),
                                              kernels.conv2d_stats_plain(x, wt, **kw), dname,
                                              own=True)
            say(f"  {n} {h} {w} {cin} {cout} {k} {s} {p} | {dname} {plan.route} {plan.bm}x{plan.bn} "
                f"{plan.gather} | {errs[0]:.3e} / {errs[1]:.3e} ({atol:g}+{rtol:g}|ref|) "
                f"{'ok' if ok else 'FAIL'} | {y_err:.3e}, {e1:.2e}, {e2:.2e} "
                f"({STATS_TOL[dname]:g}) {'ok' if s_ok else 'FAIL'} | {what}")
            if not (ok and s_ok):
                failures.append(f"conv plan {what} {dname}: fused {errs}, stats y {y_err:.3e} "
                                f"Σ {e1:.2e} Σ² {e2:.2e}")
        del x32, w32


def phase_b256_conv(model, summary):
    """Phase 4b: rows 1 and 5 in bf16 at batch B256 at every distinct
    RN50@224 conv shape, and row 7's forward (conv2d_fused with no
    epilogue), beside cuDNN's bf16 F.conv2d on the same inputs
    (channels_last), each summed by layer use into the rows' ms_b256,
    library_ms_b256 and bound_ms_b256."""
    import torch
    import torch.nn.functional as F

    from convnets_tpu_torch.ops import kernels

    g = torch.Generator(device=DEVICE).manual_seed(7)
    fused, stats = summary["conv2d_fused"], summary["conv2d_stats"]
    train = entry(summary, "conv2d_train")
    for row in (fused, stats, train):
        row.update(dict.fromkeys(B256_KEYS, 0.0))
    total = 0
    say(f"conv at batch {B256}, bf16: H W Cin Cout k s p | plan | conv2d_fused ms TFLOP/s | "
        f"conv2d_stats ms TFLOP/s | no epilogue (row 7's forward) ms | cuDNN ms TFLOP/s | "
        f"bound ms | uses")
    for (h, w, cin, cout, k, s, p, _), relus in sorted(distinct_shapes(model).items()):
        x = torch.randn(B256, h, w, cin, device=DEVICE, generator=g).to(torch.bfloat16)
        wt = (torch.randn(k, k, cin, cout, device=DEVICE, generator=g)
              / np.sqrt(k * k * cin)).to(torch.bfloat16)
        scale = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        shift = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        xc, wc = nchw(x), oihw(wt)
        f_ms = time_ms(lambda: kernels.conv2d_fused(x, wt, scale, shift, stride=s, padding=p,
                                                    relu=True), REPS)
        s_ms = time_ms(lambda: kernels.conv2d_stats(x, wt, stride=s, padding=p), REPS)
        t_ms = time_ms(lambda: kernels.conv2d_fused(x, wt, stride=s, padding=p), REPS)
        c_ms = time_ms(lambda: F.conv2d(xc, wc, stride=s, padding=p), REPS)
        flops, nbytes = conv_work(B256, h, w, cin, cout, k, s, p)
        bound = 1e3 * max(flops / PEAK_BF16, (nbytes + 8 * cout) / HBM_BPS)
        uses = len(relus)
        total += uses * flops
        m = B256 * conv_out_size(h, k, s, p) * conv_out_size(w, k, s, p)
        plan = kernels.conv_plan(torch.bfloat16, m, cin, cout)
        say(f"  {h} {w} {cin} {cout} {k} {s} {p} | {plan.bm}x{plan.bn} {plan.gather} | "
            f"{f_ms:.4f} {flops / f_ms / 1e9:.1f} | {s_ms:.4f} {flops / s_ms / 1e9:.1f} | "
            f"{t_ms:.4f} | {c_ms:.4f} {flops / c_ms / 1e9:.1f} | {bound:.4f} | {uses}")
        for row, ms in ((fused, f_ms), (stats, s_ms), (train, t_ms)):
            row["ms_b256"] += uses * ms
            row["library_ms_b256"] += uses * c_ms
            row["bound_ms_b256"] += uses * bound
        del x, wt, xc, wc
    lib_ms = fused["library_ms_b256"]
    say(f"RN50 conv layers at b{B256} bf16, summed over the 53 layers ({total / 1e9:.1f} GFLOP): "
        f"conv2d_fused {fused['ms_b256']:.3f} ms ({total / fused['ms_b256'] / 1e9:.1f} TFLOP/s, "
        f"{fused['ms_b256'] / lib_ms:.3f}x cuDNN), conv2d_stats {stats['ms_b256']:.3f} ms "
        f"({total / stats['ms_b256'] / 1e9:.1f} TFLOP/s, {stats['ms_b256'] / lib_ms:.3f}x cuDNN), "
        f"no epilogue {train['ms_b256']:.3f} ms, cuDNN bf16 {lib_ms:.3f} ms ({total / lib_ms / 1e9:.1f} TFLOP/s), bound "
        f"{fused['bound_ms_b256']:.4f} ms")


# phase 4c: the BN passes of the fused conv sites (csrc/bn_act.cu)
BN_EPS = 1e-5
BN_FLIP_SHARE = 1e-4  # ReLU-mask flips allowed, as a share of the elements
BN_FP32_REL = 1e-6  # forward out (fp32), mean and var: |Δ| / max|ref|
BN_SUMS_REL = 1e-4  # the backward's Σdz·x̂ and Σdz: summation order only
BN_LOOP_SHAPE = (8, 28, 28, 6)  # LeNet's first ConvBNReLU: C % 8 != 0, the loop route
# the extra keys of rows 6 (b256 sums over RN50's 53 sites) and of the two
# bn_act rows (their N=8 sums beside the b256 ones in ms, plain_ms, ...)
BN_KEYS = ("ms_n8", "plain_ms_n8", "bound_ms_n8", "library_ms_n8", "bn_act_ms_b256",
           "bn_act_plain_ms_b256", "bn_act_bound_ms_b256", "bn_act_library_ms_b256")


def bn_sites_of(model):
    """{(OH, OW, C): [relu flag of each fused site]} of a model's ConvBNReLUs
    (dense and grouped): the shapes bn_act runs at."""
    out = {}
    for kind, h, w, _, cout, k, s, p, relu, _ in model_layers(model):
        if kind in ("conv", "gconv"):
            out.setdefault((conv_out_size(h, k, s, p), conv_out_size(w, k, s, p), cout),
                           []).append(relu)
    return out


def bn_inputs(n, oh, ow, c, dtype, g):
    """A conv output y (per-channel means and spreads of a BN input), its
    (2, C) row of Σy, Σy², scale, bias and a cotangent, on the card."""
    import torch

    mu = 0.5 * torch.randn(c, device=DEVICE, generator=g)
    sd = 0.5 + torch.rand(c, device=DEVICE, generator=g)
    y = (torch.randn(n, oh, ow, c, device=DEVICE, generator=g) * sd + mu).to(dtype)
    yf = y.float()
    sums = torch.stack([yf.sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))])
    scale = 1.0 + 0.2 * torch.randn(c, device=DEVICE, generator=g)
    bias = 0.1 * torch.randn(c, device=DEVICE, generator=g)
    cot = torch.randn(n, oh, ow, c, device=DEVICE, generator=g).to(dtype)
    return y, sums, scale, bias, cot


def bn_route_launches():
    from convnets_tpu_torch.ops import kernels

    return {k: dict(kernels.ROUTE_LAUNCHES[k]) for k in ("bn_act_forward",
                                                          "bn_act_backward_sums",
                                                          "bn_act_backward_apply")}


def bn_check(label, y, sums, scale, bias, cot, relu, route, failures):
    """bn_act_forward and bn_act_backward against their plain versions on
    the same inputs (the backward on the kernel forward's mean and inv):
    out within one bf16 ulp (fp32: BN_FP32_REL of max|ref|) off the
    ReLU-mask flips, which must be at most BN_FLIP_SHARE of the elements;
    mean and var within BN_FP32_REL; Σdz·x̂, Σdz within BN_SUMS_REL; dy
    within CONV_TOL; every launch on `route`. Returns the largest |Δ|."""
    import torch

    from convnets_tpu_torch.ops import kernels

    dname = dname_of(y.dtype)
    m = y.numel() // y.shape[-1]
    before = bn_route_launches()
    out, mean, var, inv = kernels.bn_act_forward(y, sums, m, scale, bias, BN_EPS, relu)
    dy, dsc, dbi = kernels.bn_act_backward(cot, y, mean, inv, scale, bias, relu, m)
    after = bn_route_launches()
    rout, rmean, rvar, _ = kernels.bn_act_forward_plain(y, sums, m, scale, bias, BN_EPS, relu)
    rdy, rdsc, rdbi = kernels.bn_act_backward_plain(cot, y, mean, inv, scale, bias, relu, m)
    sync()
    flips = (out > 0) != (rout > 0)
    n_flips = int(flips.sum())
    d = (out.float() - rout.float()).abs().masked_fill(flips, 0.0)
    if dname == "bfloat16":
        out_err = float((d / bf16_ulp(rout)).max())
        out_ok = out_err <= 1.0
    else:
        out_err = float(d.max() / rout.float().abs().max().clamp_min(1e-30))
        out_ok = out_err <= BN_FP32_REL
    stat_err = max(rel_err(mean, rmean), rel_err(var, rvar))
    sum_err = max(rel_err(dsc, rdsc), rel_err(dbi, rdbi))
    atol, rtol = CONV_TOL[dname]
    dy_ok = within(dy, rdy, atol, rtol)
    routed = all(after[k][route] - before[k][route] == 1 and
                 sum(after[k].values()) - sum(before[k].values()) == 1 for k in after)
    ok = (out_ok and n_flips <= BN_FLIP_SHARE * out.numel() and stat_err <= BN_FP32_REL
          and sum_err <= BN_SUMS_REL and dy_ok and routed
          and all(bool(torch.isfinite(t).all()) for t in (out, dy, dsc, dbi)))
    dy_err = float((dy.float() - rdy.float()).abs().max())
    say(f"  {label} | {dname} relu={int(relu)} {route} | out {out_err:.2e} "
        f"({'ulp' if dname == 'bfloat16' else f'{BN_FP32_REL:g}'}) flips {n_flips} | mean/var "
        f"{stat_err:.2e} | Σ {sum_err:.2e} ({BN_SUMS_REL:g}) | dy max|Δ| {dy_err:.2e} "
        f"({atol:g}+{rtol:g}|ref|) | {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"bn_act {label} {dname} relu={relu}: out {out_err:.2e}, flips "
                        f"{n_flips}, stats {stat_err:.2e}, sums {sum_err:.2e}, dy {dy_err:.2e}, "
                        f"routes {before} -> {after}")
    return max(float(d.max()), dy_err)


def bn_mask_check(label, y, sums, scale, bias, failures):
    """The ReLU mask the backward kernels recompute equals the forward
    kernel's own, exactly: with a cotangent of small integers (exact in any
    fp32 summation order below 2^24), Σdz per channel equals the sum of the
    cotangent over the forward's out > 0."""
    import torch

    from convnets_tpu_torch.ops import kernels

    m = y.numel() // y.shape[-1]
    g = torch.Generator(device=DEVICE).manual_seed(m)
    cot = torch.randint(1, 64, y.shape, device=DEVICE, generator=g).to(y.dtype)
    out, mean, var, inv = kernels.bn_act_forward(y, sums, m, scale, bias, BN_EPS, True)
    _, _, dbias = kernels.bn_act_backward(cot, y, mean, inv, scale, bias, True, m)
    want = torch.where(out > 0, cot.double(), 0.0).sum((0, 1, 2))
    ok = bool((dbias.double() == want).all())
    say(f"  {label} | {dname_of(y.dtype)} | backward mask = forward mask: Σdz over "
        f"{int((out > 0).sum())} of {out.numel()} elements {'exact' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"bn_act {label} {dname_of(y.dtype)}: the backward's mask differs from "
                        f"the forward's ({int((dbias.double() != want).sum())} channels)")


def bn_times(y, sums, scale, bias, cot, relu):
    """Device ms of bn_act_forward, bn_act_backward (its three launches),
    their plain versions, and the ATen yardstick's forward and backward
    (F.batch_norm with training=True, then relu, on the channels-last NCHW
    view of y; the backward through autograd on one recorded graph: it
    recomputes the statistics that the kernels are handed, so it is a
    yardstick only)."""
    import torch
    import torch.nn.functional as F

    from convnets_tpu_torch.ops import kernels

    m = y.numel() // y.shape[-1]
    out, mean, var, inv = kernels.bn_act_forward(y, sums, m, scale, bias, BN_EPS, relu)
    fwd = time_ms(lambda: kernels.bn_act_forward(y, sums, m, scale, bias, BN_EPS, relu), REPS)
    bwd = time_ms(lambda: kernels.bn_act_backward(cot, y, mean, inv, scale, bias, relu, m), REPS)
    pfwd = time_ms(lambda: kernels.bn_act_forward_plain(y, sums, m, scale, bias, BN_EPS, relu),
                   REPS)
    pbwd = time_ms(lambda: kernels.bn_act_backward_plain(cot, y, mean, inv, scale, bias, relu,
                                                         m), REPS)
    yc, gc = nchw(y), nchw(cot)

    def aten_forward(yi):
        z = F.batch_norm(yi, None, None, scale, bias, training=True, eps=BN_EPS)
        return F.relu(z) if relu else z

    with torch.no_grad():
        lib_fwd = time_ms(lambda: aten_forward(yc), REPS)
    yi = yc.detach().requires_grad_()
    z = aten_forward(yi)
    lib_bwd = time_ms(lambda: torch.autograd.grad(z, yi, gc, retain_graph=True), REPS)
    return fwd, bwd, pfwd, pbwd, lib_fwd, lib_bwd


def bn_work(n, oh, ow, c, itemsize):
    """(forward bytes, backward bytes, forward ops, backward ops): y read and
    out written; g and y read and dy written (each input once, each output
    once); the sums and per-channel vectors beside them. About 6 operations
    an element forward (normalize, ReLU) and 16 backward."""
    t = n * oh * ow * c
    return (2 * itemsize * t + 4 * 5 * c, 3 * itemsize * t + 4 * 8 * c, 6 * t, 16 * t)


def phase_bn_act(model, summary, failures):
    """Phase 4c: bn_act_forward and bn_act_backward (csrc/bn_act.cu) against
    their plain versions: every distinct fused-site shape of RN50@224 at
    N=8 (fp32 and bf16, ReLU on and off) and at b256 (bf16, the sites' own
    ReLU), every one of RN26@32 at b256, and C = 6 on the loop route; the
    backward's recomputed mask against the forward's at N=8; times at N=8
    and at b256, summed over RN50's 53 sites into rows 6, bn_act_forward
    and bn_act_backward (kernel, plain, ATen yardstick, bound)."""
    import torch

    from convnets_tpu_torch.models import build_model

    g = torch.Generator(device=DEVICE).manual_seed(16)
    fwd_row, bwd_row = entry(summary, "bn_act_forward"), entry(summary, "bn_act_backward")
    for row in (fwd_row, bwd_row):
        row.update(dict.fromkeys(("ms_n8", "plain_ms_n8", "bound_ms_n8", "library_ms_n8"), 0.0))
    row6 = entry(summary, "conv_bn_relu_train")
    row6.update(dict.fromkeys(BN_KEYS[4:], 0.0))
    rn50 = bn_sites_of(model)
    say(f"bn_act vs plain (N={KERNEL_BATCH}, RN50@224's {len(rn50)} distinct fused-site shapes "
        f"of {sum(map(len, rn50.values()))}): OH OW C | dtype relu route | out err (bar) "
        f"ReLU flips | mean/var rel | Σdz·x̂, Σdz rel (bar) | dy | ok")
    for (oh, ow, c), relus in sorted(rn50.items()):
        for dtype in (torch.float32, torch.bfloat16):
            y, sums, scale, bias, cot = bn_inputs(KERNEL_BATCH, oh, ow, c, dtype, g)
            for relu in (True, False):
                err = bn_check(f"{oh} {ow} {c}", y, sums, scale, bias, cot, relu, "vector",
                               failures)
                for row in (fwd_row, bwd_row):
                    row["err"] = max(row["err"], err)
            bn_mask_check(f"{oh} {ow} {c}", y, sums, scale, bias, failures)
            for relu in sorted(set(relus)) if dtype == torch.bfloat16 else ():
                uses = relus.count(relu)
                fwd, bwd, pfwd, pbwd, lfwd, lbwd = bn_times(y, sums, scale, bias, cot, relu)
                fb, bb, fo, bo = bn_work(KERNEL_BATCH, oh, ow, c, 2)
                for row, k_ms, p_ms, l_ms, nb, ops in ((fwd_row, fwd, pfwd, lfwd, fb, fo),
                                                       (bwd_row, bwd, pbwd, lbwd, bb, bo)):
                    row["ms_n8"] += uses * k_ms
                    row["plain_ms_n8"] += uses * p_ms
                    row["library_ms_n8"] += uses * l_ms
                    row["bound_ms_n8"] += uses * 1e3 * max(nb / HBM_BPS, ops / PEAK_OTHER)
            del y, sums, scale, bias, cot
    loop = BN_LOOP_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        y, sums, scale, bias, cot = bn_inputs(*loop, dtype, g)
        for relu in (True, False):
            bn_check(" ".join(map(str, loop[1:])), y, sums, scale, bias, cot, relu, "loop",
                     failures)
        bn_mask_check(" ".join(map(str, loop[1:])), y, sums, scale, bias, failures)

    say(f"bn_act at batch {B256}, bf16 (each shape's checks first): OH OW C relu | kernel fwd "
        f"bwd ms | plain fwd bwd ms | ATen F.batch_norm+relu fwd bwd ms | bound fwd bwd ms | "
        f"sites")
    total = {"k": 0.0, "p": 0.0, "lib": 0.0, "bound": 0.0}
    for (oh, ow, c), relus in sorted(rn50.items()):
        y, sums, scale, bias, cot = bn_inputs(B256, oh, ow, c, torch.bfloat16, g)
        for relu in sorted(set(relus)):
            uses = relus.count(relu)
            bn_check(f"{oh} {ow} {c}", y, sums, scale, bias, cot, relu, "vector", failures)
            fwd, bwd, pfwd, pbwd, lfwd, lbwd = bn_times(y, sums, scale, bias, cot, relu)
            fb, bb, fo, bo = bn_work(B256, oh, ow, c, 2)
            say(f"  {oh} {ow} {c} {int(relu)} | {fwd:.4f} {bwd:.4f} | {pfwd:.4f} {pbwd:.4f} | "
                f"{lfwd:.4f} {lbwd:.4f} | {1e3 * fb / HBM_BPS:.4f} {1e3 * bb / HBM_BPS:.4f} | "
                f"{uses}")
            add_times(fwd_row, uses, fwd, pfwd, fo, fb, lfwd, PEAK_OTHER)
            add_times(bwd_row, uses, bwd, pbwd, bo, bb, lbwd, PEAK_OTHER)
            total["k"] += uses * (fwd + bwd)
            total["p"] += uses * (pfwd + pbwd)
            total["lib"] += uses * (lfwd + lbwd)
            total["bound"] += uses * 1e3 * max((fb + bb) / HBM_BPS, (fo + bo) / PEAK_OTHER)
        del y, sums, scale, bias, cot
    row6.update(bn_act_ms_b256=total["k"], bn_act_plain_ms_b256=total["p"],
                bn_act_library_ms_b256=total["lib"], bn_act_bound_ms_b256=total["bound"])
    say(f"RN50@224 BN passes at b{B256} bf16, summed over the 53 fused sites: kernels "
        f"{total['k']:.3f} ms (forward {fwd_row['ms']:.3f}, backward {bwd_row['ms']:.3f}), plain "
        f"{total['p']:.3f} ms, ATen F.batch_norm+relu fwd+bwd {total['lib']:.3f} ms (forward "
        f"{fwd_row['library_ms']:.3f}, backward {bwd_row['library_ms']:.3f}), bound "
        f"{total['bound']:.3f} ms ({100 * total['bound'] / total['k']:.1f}% of it reached); at "
        f"N={KERNEL_BATCH}: kernels {fwd_row['ms_n8'] + bwd_row['ms_n8']:.3f} ms, plain "
        f"{fwd_row['plain_ms_n8'] + bwd_row['plain_ms_n8']:.3f} ms, bound "
        f"{fwd_row['bound_ms_n8'] + bwd_row['bound_ms_n8']:.4f} ms")

    rn26 = bn_sites_of(build_model("resnet", trainer_setting(0, ""), device=DEVICE))
    say(f"bn_act vs plain at RN26@32's {len(rn26)} distinct fused-site shapes, b{B256} bf16:")
    for (oh, ow, c), relus in sorted(rn26.items()):
        y, sums, scale, bias, cot = bn_inputs(B256, oh, ow, c, torch.bfloat16, g)
        for relu in sorted(set(relus)):
            bn_check(f"{oh} {ow} {c}", y, sums, scale, bias, cot, relu, "vector", failures)
        del y, sums, scale, bias, cot


def sass_check(failures):
    """Phase 1b: HGMMA instructions in the SASS of each tensor-core conv
    instantiation of the built library (each must have some; the grouped
    mode's, CG > 0, at Cin/G = 4, 8, 16 and 32 with both epilogues, listed
    apart; the wide route's grouped_wide_kernel<NW, STATS> at NW = 16, 32,
    64 and 128 with both epilogues), and no bf16 instantiation of the dense
    CUDA-core loop `conv_kernel`. The grouped CUDA-core loop keeps its bf16
    instantiation: grouped_plan names the shapes it serves."""
    import re
    import shutil

    from convnets_tpu_torch.ops import kernels

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    r = subprocess.run([tool, "-sass", kernels.LIB_PATH], capture_output=True, text=True)
    if r.returncode != 0:
        failures.append(f"cuobjdump -sass failed ({r.returncode}): {r.stderr.strip()[:300]}")
        return
    counts, wide, fn = {}, {}, None
    for line in r.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = wide[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
        elif (fn is not None and ".128" in line  # the cheap test first: the SASS is long
              and re.search(r"\b(LDG|LDGSTS)\.E\S*\.128\b", line)):
            wide[fn] += 1
    wgmma = {f: c for f, c in counts.items() if "conv_wgmma_kernel" in f}
    # conv_wgmma_kernel<BN, STATS, VEC_A, CG> in the mangled name
    grouped = {}
    for f, c in wgmma.items():
        m = re.search(r"conv_wgmma_kernelILi(\d+)ELb([01])ELb([01])ELi(\d+)E", f)
        if m and int(m.group(4)) > 0:
            grouped[(int(m.group(4)), "stats" if m.group(2) == "1" else "fused")] = c
    simt_bf16 = [f for f in counts if "11conv_kernelI" in f and "bfloat16" in f]
    say(f"SASS: HGMMA instructions per conv_wgmma_kernel instantiation "
        f"{sorted(wgmma.values())} (total {sum(wgmma.values())}, {len(wgmma)} instantiations); "
        f"grouped mode (Cin/G, epilogue): {dict(sorted(grouped.items()))}; "
        f"bf16 instantiations of the dense CUDA-core conv_kernel: {len(simt_bf16)}")
    if not wgmma or min(wgmma.values()) == 0:
        failures.append(f"HGMMA count per conv_wgmma_kernel instantiation: {wgmma}")
    want = {(cg, e) for cg in (4, 8, 16, 32) for e in ("fused", "stats")}
    if set(grouped) != want or min(grouped.values(), default=0) == 0:
        failures.append(f"grouped wgmma instantiations and their HGMMA counts: {grouped}")
    if simt_bf16:
        failures.append(f"bf16 CUDA-core conv loop in the library: {simt_bf16}")
    # the wide route, grouped_wide_kernel<NW, STATS>: one per accumulator
    # width of a group (kernels.conv.WIDE_NW) and epilogue
    wide_route = {}
    for f, c in counts.items():
        m = re.search(r"grouped_wide_kernelILi(\d+)ELb([01])E", f)
        if m:
            wide_route[(int(m.group(1)), "stats" if m.group(2) == "1" else "fused")] = c
    say(f"SASS: HGMMA instructions per grouped_wide_kernel instantiation (NW, epilogue): "
        f"{dict(sorted(wide_route.items()))}")
    want = {(nw, e) for nw in kernels.conv.WIDE_NW for e in ("fused", "stats")}
    if set(wide_route) != want or min(wide_route.values(), default=0) == 0:
        failures.append(f"grouped_wide_kernel instantiations and their HGMMA counts: {wide_route}")
    # the block's tensor-core route, block_wgmma_kernel<Cmid, MB1>: one per
    # Cmid of kernels.block.WGMMA_CMID
    block = {}
    for f, c in counts.items():
        m = re.search(r"block_wgmma_kernelILi(\d+)ELi(\d+)E", f)
        if m:
            block[int(m.group(1))] = c
    say(f"SASS: HGMMA instructions per block_wgmma_kernel instantiation (Cmid: count): "
        f"{dict(sorted(block.items()))}")
    if set(block) != set(kernels.block.WGMMA_CMID) or min(block.values(), default=0) == 0:
        failures.append(f"block_wgmma_kernel instantiations and their HGMMA counts: {block}")
    # the window kernels' vector instantiations (8 channels per thread):
    # depthwise_vec_kernel<T, K, S, D, R, RY> (2 dtypes, 2 strides, the
    # dilations of VECTOR_DILATIONS), pool_vec_kernel<T, AVG, TAPS, 8, R>,
    # pool_bwd_kernel<T, AVG, 8>; each must move its data in 128-bit global
    # loads or 128-bit asynchronous copies (LDGSTS)
    vector = {f: wide[f] for f in wide
              if "depthwise_vec_kernel" in f or re.search(r"pool_vec_kernelI\w+?Lb[01]ELb[01]ELi8E", f)
              or re.search(r"pool_bwd_kernelI\w+?Lb[01]ELi8E", f)}
    kinds = {k: sorted(c for f, c in vector.items() if k in f)
             for k in ("depthwise_vec_kernel", "pool_vec_kernel", "pool_bwd_kernel")}
    say(f"SASS: 128-bit LDG / LDGSTS per vector instantiation of the window kernels: {kinds}")
    want = [4 * len(kernels.depthwise.VECTOR_DILATIONS), 12, 4]
    if [len(v) for v in kinds.values()] != want or min(vector.values(), default=0) == 0:
        failures.append(f"window kernels' vector instantiations without 128-bit loads: {kinds}")


def phase_train_kernels(model, failures):
    """conv2d_stats at every distinct RN50@224 conv shape; conv_bn_relu_train,
    conv2d_train and pool2d_train forward + gradients, kernel vs plain."""
    import torch

    from convnets_tpu_torch.ops import kernels

    import torch.nn.functional as F

    lib = kernels.lib()
    g = torch.Generator(device=DEVICE).manual_seed(1)
    n = KERNEL_BATCH
    summary = {}
    stats_row, reduce_row = entry(summary, "conv2d_stats"), entry(summary, "conv2d_stats_reduce")
    say("conv2d_stats (N=8): H W Cin Cout k s p | dtype | y_err tol, Σ rel, Σ² rel (tol) | "
        "kernel_ms plain_ms cudnn_bf16_ms | reduce: blocks err kernel_ms plain_ms | uses")
    for (h, w, cin, cout, k, s, p, _), relus in sorted(distinct_shapes(model).items()):
        x32 = torch.randn(n, h, w, cin, device=DEVICE, generator=g)
        w32 = torch.randn(k, k, cin, cout, device=DEVICE, generator=g) / np.sqrt(k * k * cin)
        xc, wc = nchw(x32.to(torch.bfloat16)), oihw(w32.to(torch.bfloat16))
        cudnn_ms = time_ms(lambda: F.conv2d(xc, wc, stride=s, padding=p), REPS)
        for dtype in (torch.float32, torch.bfloat16):
            dname = dname_of(dtype)
            x, wt = x32.to(dtype).contiguous(), w32.to(dtype).contiguous()
            kw = dict(stride=s, padding=p)
            ok, err, e1, e2 = stats_check(kernels.conv2d_stats(x, wt, **kw),
                                          kernels.conv2d_stats_plain(x, wt, **kw), dname)
            atol, rtol = CONV_TOL[dname]
            k_ms = time_ms(lambda: kernels.conv2d_stats(x, wt, **kw), REPS)
            p_ms = time_ms(lambda: kernels.conv2d_stats_plain(x, wt, **kw), REPS)
            # the reduction alone, on partial sums of this shape's block count
            m = n * conv_out_size(h, k, s, p) * conv_out_size(w, k, s, p)
            blocks = kernels.conv_plan(dtype, m, cin, cout).partial_rows(m)
            part = torch.randn(blocks, 2, cout, device=DEVICE, generator=g)
            out = torch.empty(2, cout, device=DEVICE)

            def reduce():
                kernels.check_launch("stats_reduce", lib.stats_reduce_launch(
                    part.data_ptr(), out.data_ptr(), blocks, cout, kernels.stream_ptr(part)))

            reduce()
            sync()
            r_err = float((out - part.sum(0)).abs().max())
            r_ok = r_err <= 1e-4 * float(part.abs().sum(0).max())
            r_ms = time_ms(reduce, REPS)
            rp_ms = time_ms(lambda: part.sum(0), REPS)
            say(f"  {h} {w} {cin} {cout} {k} {s} {p} | {dname} | {err:.3e} {atol:g}+{rtol:g}|ref|, "
                f"{e1:.2e}, {e2:.2e} ({STATS_TOL[dname]:g}) {'ok' if ok and r_ok else 'FAIL'} | "
                f"{k_ms:.4f} {p_ms:.4f} {cudnn_ms:.4f} | {blocks} {r_err:.2e} {r_ms:.4f} "
                f"{rp_ms:.4f} | {len(relus)}")
            if not (ok and r_ok):
                failures.append(f"conv2d_stats {h}x{w} {cin}->{cout} k{k} s{s} {dname}: y {err:.3e}"
                                f" Σ {e1:.2e} Σ² {e2:.2e} reduce {r_err:.2e}")
            stats_row["err"] = max(stats_row["err"], err)
            reduce_row["err"] = max(reduce_row["err"], r_err)
            if dtype == torch.bfloat16:
                flops, nbytes = conv_work(n, h, w, cin, cout, k, s, p)
                add_times(stats_row, len(relus), k_ms, p_ms, flops, nbytes + 8 * cout, cudnn_ms)
                # the partials read once, the sums written once; part.sum(0)
                # is both the plain version and the library call
                add_times(reduce_row, len(relus), r_ms, rp_ms, part.numel(),
                          4 * (part.numel() + out.numel()), rp_ms, PEAK_OTHER)
    say(f"RN50 conv2d_stats at N=8 bf16, summed over the 53 layers: kernel "
        f"{stats_row['ms']:.3f} ms (reduction alone {reduce_row['ms']:.3f}), plain "
        f"{stats_row['plain_ms']:.3f} ms, cuDNN bf16 conv {stats_row['library_ms']:.3f} ms, "
        f"bound {stats_row['bound_ms']:.4f} ms")

    # the trainable functions: forward and every gradient, the kernel path
    # against the same function with the plain versions swapped in
    shapes = [(IMAGE, IMAGE, 3, 64, 7, 2, 3), (IMAGE // 4, IMAGE // 4, 128, 128, 3, 2, 1)]
    say("trainable functions (N=8): fn H Cin Cout k s | dtype | out max|Δ|/max|ref| (tol) | "
        "gradients ‖Δ‖/‖g‖ (tol) [max|Δ|/max|g|] | ReLU mask flips | fwd+bwd kernel_ms "
        "plain_ms library_ms")
    for h, w, cin, cout, k, s, p in shapes:
        x32 = torch.randn(n, h, w, cin, device=DEVICE, generator=g)
        w32 = torch.randn(k, k, cin, cout, device=DEVICE, generator=g) / np.sqrt(k * k * cin)
        sc32 = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        bi32 = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            dname = dname_of(dtype)
            x, wt = x32.to(dtype), w32.to(dtype)
            label = f"{h} {cin} {cout} {k} {s}"
            work = conv_train_work(n, h, w, cin, cout, k, s, p)
            check_trainable("conv_bn_relu_train", label, lambda a, b, c, d: kernels.conv_bn_relu_train(
                a, b, c, d, s, p)[0], [x, wt, sc32, bi32], dname, g, summary, failures,
                CONV_TOL[dname][1], work)
            check_trainable("conv2d_train", label, lambda a, b: kernels.conv2d_train(a, b, s, p),
                            [x, wt], dname, g, summary, failures, CONV_TOL[dname][1], work,
                            conv_lib(s, p))

    # the stem pool's dx: the same VJP on the same forward, so exactly equal
    _, h, w, c, _, k, s, p, _, _ = [l for l in model_layers(model) if l[0] == "maxpool"][0]
    pool_row = entry(summary, "pool2d_train")
    x32 = torch.relu(torch.randn(n, h, w, c, device=DEVICE, generator=g))  # tied zeros
    for dtype in (torch.float32, torch.bfloat16):
        dname = dname_of(dtype)

        def run():
            xi = x32.to(dtype).requires_grad_()
            out = kernels.pool2d_train(xi, "max", k, s, p)
            return [out.detach(), *torch.autograd.grad(out, xi, torch.ones_like(out))]

        def run_lib():
            xi = x32.to(dtype).requires_grad_()
            out = pool_lib("max", k, s, p)(xi)
            return [out.detach(), *torch.autograd.grad(out, xi, torch.ones_like(out))]

        got = run()
        with plain_kernels():
            ref = run()
        sync()
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
        k_ms = time_ms(run, REPS)
        with plain_kernels():
            p_ms = time_ms(run, REPS)
        lib_ms = time_ms(run_lib, REPS)
        say(f"  pool2d_train {h} {c} {k} {s} | {dname} | out and dx max|Δ| {err:.3e} "
            f"(exact) {'ok' if err <= POOL_TOL else 'FAIL'} | {k_ms:.4f} {p_ms:.4f} {lib_ms:.4f}")
        if err > POOL_TOL:
            failures.append(f"pool2d_train {dname}: err {err:.3e}")
        pool_row["err"] = max(pool_row["err"], err)
        if dtype == torch.bfloat16:
            # x and the cotangent read, y and dx written; k² compares each way
            add_times(pool_row, 1, k_ms, p_ms, 2 * k * k * got[0].numel(),
                      4 * (x32.numel() + got[0].numel()), lib_ms, PEAK_OTHER)
    return summary


def avg_pool_ok(got, ref, dname):
    """(ok, error as bounded): fp32 max|Δ| / max|ref|; bf16 max |Δ| / ulp(ref)."""
    d = (got.float() - ref.float()).abs()
    if dname == "float32":
        err = float(d.max() / ref.float().abs().max().clamp_min(1e-30))
        return err <= AVG_POOL_TOL, err
    err = float((d / bf16_ulp(ref)).max())
    return err <= 1.0, err


def bf16_ulp(ref):
    """The bf16 ulp of each element of ref: 2^(floor(log2|ref|) - 7)."""
    import torch

    mag = ref.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def phase_zoo_kernels(failures):
    """This slice's kernels vs plain at batch 8: depthwise_conv2d at every
    distinct MobileNet-v1@224 depthwise shape, avg_pool2d at DenseNet-121's
    transitions, and the trainable depthwise conv and avg pool."""
    import torch
    import torch.nn.functional as F

    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.ops import kernels

    mobilenet = build_model("mobilenet_v1", model_setting("mobilenet_v1", 0, True), device=DEVICE)
    densenet = build_model("densenet", model_setting("densenet", 0, True), device=DEVICE)
    dw = distinct_shapes(mobilenet, ("dwconv",))
    pools = distinct_shapes(densenet, ("avgpool",))
    n_dw = sum(len(v) for v in dw.values())
    n_avg = sum(len(v) for v in pools.values())
    if (len(dw), n_dw, len(pools), n_avg) != (9, SERVE_LAUNCHES["mobilenet_v1"]["depthwise_conv2d"],
                                              3, SERVE_LAUNCHES["densenet"]["avg_pool2d"]):
        failures.append(f"zoo walk found {len(dw)} depthwise shapes ({n_dw} layers), "
                        f"{len(pools)} avg pools ({n_avg} layers)")
    g = torch.Generator(device=DEVICE).manual_seed(2)
    n = KERNEL_BATCH
    summary = {}
    dw_row, avg_row = entry(summary, "depthwise_conv2d"), entry(summary, "avg_pool2d")
    say("depthwise_conv2d (N=8): H W C k s p | dtype | max_abs_err tol | kernel_ms plain_ms "
        "cudnn_bf16_ms | uses")
    for (h, w, c, _, k, s, p, _), uses in sorted(dw.items()):
        x32 = torch.randn(n, h, w, c, device=DEVICE, generator=g)
        w32 = torch.randn(k, k, 1, c, device=DEVICE, generator=g) / k
        xc, wc = nchw(x32.to(torch.bfloat16)), oihw(w32.to(torch.bfloat16))
        cudnn_ms = time_ms(lambda: F.conv2d(xc, wc, stride=s, padding=p, groups=c), REPS)
        for dtype in (torch.float32, torch.bfloat16):
            dname = dname_of(dtype)
            x, wt = x32.to(dtype), w32.to(dtype)
            kw = dict(stride=s, padding=p)
            got = kernels.depthwise_conv2d(x, wt, **kw)
            ref = kernels.depthwise_conv2d_plain(x, wt, **kw)
            sync()
            atol, rtol = CONV_TOL[dname]
            err = float((got.float() - ref.float()).abs().max())
            ok = within(got, ref, atol, rtol) and bool(torch.isfinite(got).all())
            k_ms = time_ms(lambda: kernels.depthwise_conv2d(x, wt, **kw), REPS)
            p_ms = time_ms(lambda: kernels.depthwise_conv2d_plain(x, wt, **kw), REPS)
            say(f"  {h} {w} {c} {k} {s} {p} | {dname} | {err:.3e} {atol:g}+{rtol:g}|ref| "
                f"{'ok' if ok else 'FAIL'} | {k_ms:.4f} {p_ms:.4f} {cudnn_ms:.4f} | {len(uses)}")
            if not ok:
                failures.append(f"depthwise_conv2d {h}x{w} C{c} s{s} {dname}: err {err:.3e}")
            dw_row["err"] = max(dw_row["err"], err)
            if dtype == torch.bfloat16:
                add_times(dw_row, len(uses), k_ms, p_ms,
                          *conv_work(n, h, w, c, c, k, s, p, groups=c), cudnn_ms)

    say(f"avg_pool2d (N=8): H W C k s p | dtype | error (fp32: max|Δ|/max|ref| ≤ {AVG_POOL_TOL:g}; "
        f"bf16: max |Δ|/ulp ≤ 1) | kernel_ms plain_ms F.avg_pool2d_ms | uses")
    for (h, w, c, _, k, s, p, _), uses in sorted(pools.items()):
        x32 = torch.randn(n, h, w, c, device=DEVICE, generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            dname = dname_of(dtype)
            x = x32.to(dtype)
            got = kernels.avg_pool2d(x, k, s, p)
            ref = kernels.avg_pool2d_plain(x, k, s, p)
            sync()
            ok, err = avg_pool_ok(got, ref, dname)
            ok = ok and got.shape == ref.shape
            k_ms = time_ms(lambda: kernels.avg_pool2d(x, k, s, p), REPS)
            p_ms = time_ms(lambda: kernels.avg_pool2d_plain(x, k, s, p), REPS)
            lib_ms = time_ms(lambda: F.avg_pool2d(nchw(x), k, s, p), REPS)
            say(f"  {h} {w} {c} {k} {s} {p} | {dname} | {err:.3e} {'ok' if ok else 'FAIL'} | "
                f"{k_ms:.4f} {p_ms:.4f} {lib_ms:.4f} | {len(uses)}")
            if not ok:
                failures.append(f"avg_pool2d {h}x{w} C{c} {dname}: err {err:.3e}")
            avg_row["err"] = max(avg_row["err"], float((got.float() - ref.float()).abs().max()))
            if dtype == torch.bfloat16:
                add_times(avg_row, len(uses), k_ms, p_ms, k * k * got.numel(),
                          2 * (x.numel() + got.numel()), lib_ms, PEAK_OTHER)
    say(f"MobileNet-v1 depthwise layers at N=8 bf16, summed over the 13 layers: kernel "
        f"{dw_row['ms']:.4f} ms, plain {dw_row['plain_ms']:.4f} ms, cuDNN bf16 "
        f"{dw_row['library_ms']:.4f} ms, bound {dw_row['bound_ms']:.4f} ms; DenseNet-121 avg "
        f"pools, summed over the 3: kernel {avg_row['ms']:.4f} ms, plain "
        f"{avg_row['plain_ms']:.4f} ms, F.avg_pool2d {avg_row['library_ms']:.4f} ms")

    say("trainable functions (N=8): fn H C s | dtype | out max|Δ|/max|ref| (tol) | "
        "gradients ‖Δ‖/‖g‖ (tol) [max|Δ|/max|g|] | sign flips | fwd+bwd kernel_ms plain_ms "
        "library_ms")
    for h, c, s in ((IMAGE // 4, 128, 1), (IMAGE // 4, 128, 2)):
        x32 = torch.randn(n, h, h, c, device=DEVICE, generator=g)
        w32 = torch.randn(3, 3, 1, c, device=DEVICE, generator=g) / 3
        for dtype in (torch.float32, torch.bfloat16):
            dname = dname_of(dtype)
            check_trainable("depthwise_train", f"{h} {c} {s}",
                            lambda a, b: kernels.depthwise_train(a, b, s, 1),
                            [x32.to(dtype), w32.to(dtype)], dname, g, summary, failures,
                            CONV_TOL[dname][1], conv_train_work(n, h, h, c, c, 3, s, 1, c),
                            conv_lib(s, 1, c))
    (h, w, c, _, k, s, p, _), _ = sorted(pools.items())[-1]  # the first transition, 56²
    x32 = torch.randn(n, h, w, c, device=DEVICE, generator=g)
    out_numel = n * (h // s) * (w // s) * c
    for dtype in (torch.float32, torch.bfloat16):
        dname = dname_of(dtype)
        check_trainable("pool2d_train_avg", f"{h} {c} {k} {s}",
                        lambda a: kernels.pool2d_train(a, "avg", k, s, p), [x32.to(dtype)],
                        dname, g, summary, failures,
                        AVG_POOL_TOL if dname == "float32" else 2.0 ** -7,
                        (2 * k * k * out_numel, 4 * (x32.numel() + out_numel)),
                        pool_lib("avg", k, s, p), PEAK_OTHER)
    return summary


def pool_backward_lib(mode, x, k, s, p):
    """ATen's pool backward as one call on NCHW views of NHWC tensors: the
    same dx from g and, for max, F.max_pool2d's own indices."""
    import torch
    import torch.nn.functional as F

    xc = nchw(x)
    if mode == "max":
        idx = F.max_pool2d(xc, k, s, p, return_indices=True)[1]
        return lambda g: torch.ops.aten.max_pool2d_with_indices_backward(
            nchw(g), xc, [k, k], [s, s], [p, p], [1, 1], False, idx)
    return lambda g: torch.ops.aten.avg_pool2d_backward(nchw(g), xc, [k, k], [s, s], [p, p],
                                                        False, True, None)


def phase_window_routes(summary, failures):
    """Phase 6, the window kernels' two routes at batch 8, fp32 and bf16:
    the vector route against the loop, bit for bit (torch.equal), at the 9
    MobileNet-v1 depthwise shapes and at every pool shape of the four
    families (y, the max pool's taps, and pool2d_backward's dx); the taps
    and dx against their plain versions (taps and max dx exact, avg dx
    fp32 1e-6 relative, bf16 one ulp); pool2d_backward alone beside its
    plain version and ATen's backward (the pool2d_backward row)."""
    import torch

    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.ops.kernels import pool as kpool

    g = torch.Generator(device=DEVICE).manual_seed(11)
    n = KERNEL_BATCH
    row = entry(summary, "pool2d_backward")
    say("window kernels' routes (N=8): kernel H W C k s p | dtype | plan | vector == loop | "
        "vs plain: taps, dx error (ok) | pool2d_backward kernel_ms plain_ms ATen_ms | uses")
    for kind, shapes in window_layers().items():
        for (h, w, c, _, k, s, p, _), uses in sorted(shapes.items()):
            x32 = torch.randn(n, h, w, c, device=DEVICE, generator=g)
            for dtype in (torch.float32, torch.bfloat16):
                dname, x = dname_of(dtype), x32.to(dtype)
                vs_plain, times = "-", ""
                if kind == "dwconv":
                    name = "depthwise_conv2d"
                    wt = (torch.randn(k, k, 1, c, device=DEVICE, generator=g) / k).to(dtype)
                    plan = kernels.depthwise_plan(n, h, w, c, k, k, s, p, dtype)
                    same = torch.equal(
                        kernels.depthwise_conv2d(x, wt, stride=s, padding=p, route="vector"),
                        kernels.depthwise_conv2d(x, wt, stride=s, padding=p, route="loop"))
                    ok = same
                else:
                    mode = kind[:3]
                    name = f"{mode}_pool2d"
                    plan = kernels.pool_plan(n, h, w, c, k, k, s, p, dtype)
                    taps = mode == "max"
                    ya, ta = kpool._forward(mode, x, k, s, p, taps, route="vector")
                    yb, tb = kpool._forward(mode, x, k, s, p, taps, route="loop")
                    cot = torch.randn(ya.shape, device=DEVICE, generator=g).to(dtype)
                    bwd = (mode, cot, ta, (h, w), dtype, k, s, p)
                    da = kernels.pool2d_backward(*bwd, route="vector")
                    db = kernels.pool2d_backward(*bwd, route="loop")
                    same = (torch.equal(ya, yb) and torch.equal(da, db)
                            and (ta is None or torch.equal(ta, tb)))
                    ref = kernels.pool2d_backward_plain(*bwd)
                    sync()
                    taps_ok = ta is None or torch.equal(
                        ta, kernels.max_pool2d_plain(x, k, s, p, taps=True)[1])
                    if mode == "max":
                        err = float((da.float() - ref.float()).abs().max())
                        dx_ok = err == 0.0
                    else:
                        dx_ok, err = avg_pool_ok(da, ref, dname)
                    ok = same and taps_ok and dx_ok
                    vs_plain = f"{'-' if ta is None else taps_ok}, {err:.3e} ({dx_ok})"
                    row["err"] = max(row["err"], float((da.float() - ref.float()).abs().max()))
                    if dtype == torch.bfloat16:
                        k_ms = time_ms(lambda: kernels.pool2d_backward(*bwd), REPS)
                        p_ms = time_ms(lambda: kernels.pool2d_backward_plain(*bwd), REPS)
                        lib = pool_backward_lib(mode, x, k, s, p)
                        lib_ms = time_ms(lambda: lib(cot), REPS)
                        # g (and the taps) read, dx written; a compare-add per
                        # covering window of each input element
                        nbytes = 2 * (cot.numel() + x.numel()) + (cot.numel() if taps else 0)
                        add_times(row, len(uses), k_ms, p_ms, (-(-k // s)) ** 2 * x.numel(), nbytes,
                                  lib_ms, PEAK_OTHER)
                        times = f"{k_ms:.4f} {p_ms:.4f} {lib_ms:.4f}"
                say(f"  {name} {h} {w} {c} {k} {s} {p} | {dname} | {plan.route} {plan.cb}x"
                    f"{plan.th}x{plan.tw}/{plan.ry}x{plan.r} | {same} | {vs_plain} | {times} | {len(uses)}")
                if not ok or plan.route != "vector":
                    failures.append(f"{name} {h}x{w} C{c} k{k} s{s} {dname}: route {plan.route}, "
                                    f"vector == loop {same}, vs plain {vs_plain}")


def window_layers():
    """{kind: {(H, W, Cin, Cout, k, stride, pad, groups): [relu flags]}} of
    the window kernels' layers: MobileNet-v1@224's depthwise convs (9
    shapes, 13 layers), the stem max pool that RN50, DN121 and ResNeXt-50
    share (RN50's modules) and DN121@224's avg pools (3 shapes)."""
    from convnets_tpu_torch.models import build_model

    out = {}
    for arch, kind in (("mobilenet_v1", "dwconv"), ("resnet", "maxpool"), ("densenet", "avgpool")):
        model = build_model(arch, model_setting(arch, 0, True), device=DEVICE)
        out[kind] = distinct_shapes(model, (kind,))
        del model
    return out


def pool_train_ms(mode, x, k, s, p, g):
    """Device ms of pool2d_train's forward + backward on x with cotangent g:
    the kernel path, the plain path (plain_kernels) and F's pool with its
    own backward, NHWC in and out."""
    import torch

    from convnets_tpu_torch.ops import kernels

    def run(fn):
        xi = x.detach().requires_grad_()
        out = fn(xi)
        return torch.autograd.grad(out, xi, g)

    ours = lambda a: kernels.pool2d_train(a, mode, k, s, p)  # noqa: E731
    k_ms = time_ms(lambda: run(ours), REPS)
    with plain_kernels():
        p_ms = time_ms(lambda: run(ours), REPS)
    lib_ms = time_ms(lambda: run(pool_lib(mode, k, s, p)), REPS)
    return k_ms, p_ms, lib_ms


def phase_b256_windows(summary):
    """Phase 6b: rows 2, 3, 4 and 9 in bf16 at batch B256: depthwise_conv2d
    at MobileNet-v1's 9 depthwise shapes (13 layers), max_pool2d at the stem,
    avg_pool2d at DN121's 3 transitions, and pool2d_train forward +
    backward at the stem (max) and the first transition (avg), each beside
    its plain version, the one F call (cuDNN / ATen) and its bound, and the
    forward kernels beside their loop route on the same inputs, summed by
    layer use into the rows' ms_b256, plain_ms_b256, loop_ms_b256,
    library_ms_b256 and bound_ms_b256."""
    import torch
    import torch.nn.functional as F

    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.ops.kernels import pool as kpool

    g = torch.Generator(device=DEVICE).manual_seed(10)
    layers = window_layers()
    rows = {name: entry(summary, name) for name in
            ("depthwise_conv2d", "max_pool2d", "avg_pool2d", "pool2d_train", "pool2d_train_avg")}
    for name, row in rows.items():
        row.update(dict.fromkeys(B256_KEYS + (PLAIN_B256,), 0.0))
        if not name.startswith("pool2d_train"):
            row[LOOP_B256] = 0.0

    def add(row, uses, k_ms, p_ms, lib_ms, nbytes, ops, loop_ms=None):
        bound = 1e3 * max(ops / PEAK_OTHER, nbytes / HBM_BPS)
        row["ms_b256"] += uses * k_ms
        row[PLAIN_B256] += uses * p_ms
        row["library_ms_b256"] += uses * lib_ms
        row["bound_ms_b256"] += uses * bound
        if loop_ms is not None:
            row[LOOP_B256] += uses * loop_ms
        return bound

    say(f"window kernels at batch {B256}, bf16: kernel H W C k s p | plan | kernel ms GB/s | "
        f"loop route ms | plain ms | F ms | bound ms, share | uses")
    for kind, shapes in layers.items():
        for (h, w, c, _, k, s, p, _), uses in sorted(shapes.items()):
            x = torch.randn(B256, h, w, c, device=DEVICE, generator=g).to(torch.bfloat16)
            oh, ow = conv_out_size(h, k, s, p), conv_out_size(w, k, s, p)
            out_numel = B256 * oh * ow * c
            if kind == "dwconv":
                name = "depthwise_conv2d"
                plan = kernels.depthwise_plan(B256, h, w, c, k, k, s, p, torch.bfloat16)
                wt = (torch.randn(k, k, 1, c, device=DEVICE, generator=g) / k).to(torch.bfloat16)
                xc, wc = nchw(x), oihw(wt)
                kw = dict(stride=s, padding=p)
                k_ms = time_ms(lambda: kernels.depthwise_conv2d(x, wt, **kw), REPS)
                l_ms = time_ms(lambda: kernels.depthwise_conv2d(x, wt, **kw, route="loop"), REPS)
                p_ms = time_ms(lambda: kernels.depthwise_conv2d_plain(x, wt, **kw), REPS)
                lib_ms = time_ms(lambda: F.conv2d(xc, wc, stride=s, padding=p, groups=c), REPS)
                flops, nbytes = conv_work(B256, h, w, c, c, k, s, p, groups=c)
            else:
                name, mode = ("max_pool2d", "max") if kind == "maxpool" else ("avg_pool2d", "avg")
                plan = kernels.pool_plan(B256, h, w, c, k, k, s, p, torch.bfloat16)
                fn, plain = getattr(kernels, name), getattr(kernels, PLAIN[name])
                k_ms = time_ms(lambda: fn(x, k, s, p), REPS)
                l_ms = time_ms(lambda: kpool._forward(mode, x, k, s, p, route="loop"), REPS)
                p_ms = time_ms(lambda: plain(x, k, s, p), REPS)
                lib_ms = time_ms(lambda: pool_lib(mode, k, s, p)(x), REPS)
                flops, nbytes = k * k * out_numel, 2 * (x.numel() + out_numel)
            bound = add(rows[name], len(uses), k_ms, p_ms, lib_ms, nbytes, flops, l_ms)
            say(f"  {name} {h} {w} {c} {k} {s} {p} | {plan.route} {plan.cb}x{plan.th}x{plan.tw}/"
                f"{plan.ry}x{plan.r} | {k_ms:.4f} {nbytes / k_ms / 1e6:.1f} | {l_ms:.4f} | {p_ms:.4f} | "
                f"{lib_ms:.4f} | {bound:.4f}, {100 * bound / k_ms:.1f}% | {len(uses)}")
            if kind != "dwconv" and h == max(shape[0] for shape in shapes):
                # pool2d_train at the stem and at the first transition:
                # x and the cotangent read, y and dx written
                name = "pool2d_train" if mode == "max" else "pool2d_train_avg"
                cot = torch.randn(B256, oh, ow, c, device=DEVICE, generator=g).to(torch.bfloat16)
                k_ms, p_ms, lib_ms = pool_train_ms(mode, x, k, s, p, cot)
                bound = add(rows[name], 1, k_ms, p_ms, lib_ms, 4 * (x.numel() + out_numel),
                            2 * k * k * out_numel)
                say(f"  {name} (fwd+bwd) {h} {w} {c} {k} {s} {p} | | {k_ms:.4f} | | {p_ms:.4f} | "
                    f"{lib_ms:.4f} | {bound:.4f}, {100 * bound / k_ms:.1f}% | 1")
                del cot
            del x
    for name, row in rows.items():
        loop = f", loop route {row[LOOP_B256]:.4f} ms" if LOOP_B256 in row else ""
        say(f"{name} at b{B256} bf16, summed over its layers: kernel {row['ms_b256']:.4f} ms"
            f"{loop}, plain {row[PLAIN_B256]:.4f} ms, F {row['library_ms_b256']:.4f} ms "
            f"({row['ms_b256'] / row['library_ms_b256']:.3f}x), bound {row['bound_ms_b256']:.4f} ms "
            f"({100 * row['bound_ms_b256'] / row['ms_b256']:.1f}% of it)")


def train_state(model, **kw):
    from convnets_tpu_torch.train import build_train_step, create_train_state

    state = create_train_state(model)
    return state, build_train_step(state, **kw)


def relu_outputs(model):
    """The modules whose outputs are ReLU outputs: fused ConvBNReLUs with
    ReLU, Adds with post-ReLU, and ReLU layers outside a ConvBNReLU."""
    from convnets_tpu_torch import nn

    inner = {id(m._modules["2"]) for m in model.modules()
             if isinstance(m, nn.ConvBNReLU) and m.act}
    return [m for m in model.modules()
            if (isinstance(m, nn.ConvBNReLU) and m.act) or getattr(m, "post_relu", False)
            or (isinstance(m, nn.ReLU) and id(m) not in inner)]


def step_check(arch, seed, failures, make=None, batch=STEP_BATCH, image=IMAGE, classes=1000,
               low_control=False, cancelled=()):
    """(i) one fp32 SGD step at batch 8 with dropout 0: kernel path vs plain
    path, and the plain path against itself with perturbed conv weights.
    make(**setting fields): another model than the family's at 224² (phase
    10 runs RN26@32 at batch 64). low_control: also the plain path in bf16,
    which the gradient bar must reject. cancelled: suffixes of the leaves
    whose true gradient is 0 (CANCELLED_LEAVES), each held to the bar
    against the median leaf norm of the step instead of its own."""
    import torch

    from convnets_tpu_torch import bridge

    make = make or (lambda **kw: make_model(arch, seed, False, **kw))
    rng = np.random.default_rng(seed + 2)
    x = torch.from_numpy(rng.integers(0, 256, (batch, image, image, 3),
                                      dtype=np.uint8)).to(DEVICE)
    y = torch.from_numpy(rng.integers(0, classes, batch)).to(DEVICE)
    # SGD with no momentum or decay at lr 2^20: the update lr·g is exact and
    # dwarfs p, so (p_before - p_after) / lr reads the step's gradients back
    # to fp32 rounding
    lr = 2.0 ** 20
    results, masks = {}, {}
    for path in ("kernel", "plain", "control") + (("bf16",) if low_control else ()):
        model = make(dropout_rate=0.0, optimizer="sgd", learning_rate=lr, momentum=0.0,
                     weight_decay=0.0, mixed_precision=path == "bf16")
        if path == "control":
            gen = torch.Generator(device=DEVICE).manual_seed(seed)
            with torch.no_grad():
                for p in model.parameters():
                    if p.ndim == 4:
                        p.mul_(1 + CONTROL_PERTURBATION * torch.randn(
                            p.shape, device=DEVICE, generator=gen))
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        masks[path] = []
        for mod in relu_outputs(model):
            mod.register_forward_hook(lambda m, i, o, out=masks[path]: out.append(o > 0))
        state, step = train_state(model)
        with plain_kernels() if path != "kernel" else contextlib.nullcontext():
            loss, _ = step(state, x, y)
        sync()
        grads = {k: (before[k] - p.detach()) / lr for k, p in model.named_parameters()}
        results[path] = (float(loss), grads, bridge.export_jax_variables(model)["state"])
        del model, state
    flips = {k: sum(int((a != b).sum()) for a, b in zip(masks[k], masks["plain"]))
             for k in ("kernel", "control")}
    relu_elems = sum(m.numel() for m in masks["plain"])
    del masks
    (lk, gk, sk), (lp, gp, sp) = results["kernel"], results["plain"]
    gc = results["control"][1]
    zero = [k for k in gp if k.endswith(tuple(cancelled))] if cancelled else []
    median = float(np.median([float(g.norm()) for g in gp.values()]))

    def gap(a, b, k):
        if k in zero:
            return float((a - b).norm()) / median
        return l2_err(a, b)

    c_l2 = sorted(gap(gc[k], gp[k], k) for k in gp)
    loss_rel = abs(lk - lp) / abs(lp)
    g_l2 = {k: gap(gk[k], gp[k], k) for k in gp}
    g_max = {k: rel_err(gk[k], gp[k]) for k in gp}
    worst_l2, worst_max = max(g_l2, key=g_l2.get), max(g_max, key=g_max.get)
    flat_k, flat_p = bridge._flatten(sk), bridge._flatten(sp)
    s_err = max(float(np.abs(flat_k[k] - flat_p[k]).max() / max(np.abs(flat_p[k]).max(), 1e-30))
                for k in flat_p)
    ok = (loss_rel <= 1e-4 and g_l2[worst_l2] <= STEP_GRAD_TOL and s_err <= 1e-4
          and np.isfinite(lk) and all(bool(torch.isfinite(t).all()) for t in gk.values()))
    say(f"(i) fp32 {arch} SGD step (batch {batch}), kernel vs plain path: loss {lk:.6f} vs "
        f"{lp:.6f} (rel {loss_rel:.2e}, tol 1e-4); ReLU mask flips {flips['kernel']} of "
        f"{relu_elems}; gradients over {len(gp)} leaves: worst "
        f"‖Δ‖/‖g‖ {g_l2[worst_l2]:.2e} at {worst_l2} (tol {STEP_GRAD_TOL:g}), worst "
        f"max|Δ|/max|g| {g_max[worst_max]:.2e} at {worst_max} (max|g| "
        f"{float(gp[worst_max].abs().max()):.3e}); median ‖Δ‖/‖g‖ "
        f"{float(np.median(list(g_l2.values()))):.2e}; BN running stats rel {s_err:.2e} "
        f"(tol 1e-4) {'ok' if ok else 'FAIL'}"
        + (f"\n    {len(zero)} leaves with a true gradient of 0 ({', '.join(cancelled)}: "
           f"largest |g| {max(float(gp[k].abs().max()) for k in zero):.3e}) held against the "
           f"step's median leaf norm {median:.3e}: worst {max(g_l2[k] for k in zero):.2e}"
           if zero else "")
        + f"\n    control, plain vs plain with conv weights "
        f"×(1 + {CONTROL_PERTURBATION:g}·N(0,1)): loss {results['control'][0]:.6f}, "
        f"{flips['control']} flips, ‖Δ‖/‖g‖ median {c_l2[len(c_l2) // 2]:.2e} max {c_l2[-1]:.2e}")
    if not ok:
        failures.append(f"fp32 {arch} train step: loss {loss_rel:.2e}, grads "
                        f"{g_l2[worst_l2]:.2e}, BN {s_err:.2e}")
    read = {"worst_grad_l2": g_l2[worst_l2], "control_worst_grad_l2": c_l2[-1],
            "bar": STEP_GRAD_TOL, "zero_gradient_leaves": len(zero)}
    if low_control:
        b_l2 = sorted(l2_err(results["bf16"][1][k], gp[k]) for k in gp)
        rejects = b_l2[-1] > STEP_GRAD_TOL
        say(f"    lower-precision control, the plain path in bf16 vs plain fp32: ‖Δ‖/‖g‖ median "
            f"{b_l2[len(b_l2) // 2]:.2e} max {b_l2[-1]:.2e}, outside the bar {STEP_GRAD_TOL:g}: "
            f"{'ok' if rejects else 'FAIL'}")
        if not rejects:
            failures.append(f"fp32 {arch} train step: the bar {STEP_GRAD_TOL:g} passes the bf16 "
                            f"control ({b_l2[-1]:.2e})")
        read["bf16_worst_grad_l2"] = b_l2[-1]
    return read


def learn_check(arch, seed, failures):
    """(ii) bf16 learning check: ten Adam steps on one batch of 32, both
    paths, with the normalization the serving check bakes in. Returns the
    kernel path's model with its batch and labels, its BN running
    statistics brought to that batch, to be served."""
    import torch

    from convnets_tpu_torch import nn

    rng = np.random.default_rng(seed + 3)
    x = torch.from_numpy(rng.integers(0, 256, (LEARN_BATCH, IMAGE, IMAGE, 3),
                                      dtype=np.uint8)).to(DEVICE)
    y = torch.from_numpy(rng.integers(0, 1000, LEARN_BATCH)).to(DEVICE)
    losses = {}
    for path in ("plain", "kernel"):
        model = make_model(arch, seed, True, dropout_rate=0.0, learning_rate=LEARN_LR[arch])
        state, step = train_state(model, norm=True, stats=IMAGENET_STATS)
        with plain_kernels() if path == "plain" else contextlib.nullcontext():
            losses[path] = [float(step(state, x, y)[0]) for _ in range(LEARN_STEPS)]
    # steps at lr 0 leave the weights as they are and bring the BN running
    # statistics to this batch's, so eval mode computes what train mode
    # learned
    state.lr = 0.0
    bns = [(m, m.momentum) for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    for bn, _ in bns:
        bn.momentum = SETTLE_MOMENTUM
    for _ in range(SETTLE_STEPS):
        step(state, x, y)
    for bn, momentum in bns:
        bn.momentum = momentum
    del state
    falls = losses["kernel"][-1] < losses["kernel"][0] and all(np.isfinite(losses["kernel"]))
    say(f"(ii) bf16 {arch}, {LEARN_STEPS} Adam steps (lr {LEARN_LR[arch]:g}) on one batch of "
        f"{LEARN_BATCH}, "
        f"loss per step:\n  kernel {[round(v, 3) for v in losses['kernel']]}\n"
        f"  plain  {[round(v, 3) for v in losses['plain']]}\n"
        f"  kernel path's loss falls: {'ok' if falls else 'FAIL'}")
    if not falls:
        failures.append(f"bf16 {arch} loss did not fall: {losses['kernel']}")
    return model, x.cpu().numpy(), y.cpu().numpy()


def nobn_check(arch, seed, failures):
    """The batch_norm=False net, one bf16 Adam step: conv2d_train on every
    dense conv, grouped_conv2d_train on every grouped one (RN50: phase 5
    (iv); ResNeXt-26: phase 9 (v)). Its launches are those of the served
    forward and the stem pool's backward."""
    import torch

    from convnets_tpu_torch.ops import kernels

    model = make_model(arch, seed, True, conv_gain=0.5, batch_norm=False)
    state, step = train_state(model, debug=True)
    rng = np.random.default_rng(seed + 4)
    x = torch.from_numpy(rng.integers(0, 256, (NOBN_BATCH, IMAGE, IMAGE, 3),
                                      dtype=np.uint8)).to(DEVICE)
    y = torch.from_numpy(rng.integers(0, 1000, NOBN_BATCH)).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    sync()
    kernels.reset_launches()
    loss, _, gnorm = step(state, x, y, generator=gen)
    sync()
    launches = dict(kernels.LAUNCHES)
    want = launches_of({**SERVE_LAUNCHES[arch],
                        "pool2d_backward": TRAIN_LAUNCHES[arch]["pool2d_backward"]})
    check_routes(f"{arch} batch_norm=False step", launches, failures)
    ok = launches == want and bool(torch.isfinite(gnorm)) and bool(torch.isfinite(loss))
    say(f"bf16 {arch} batch_norm=False, one Adam step at batch {NOBN_BATCH}: launches "
        f"{launches} (expected {want}); loss {float(loss):.4f}, gradient global norm "
        f"{float(gnorm):.4e} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{arch} no-BN step: launches {launches}, loss {float(loss)}, "
                        f"|g| {float(gnorm)}")
    return launches


def timed_steps(step, state, x, y, gen, depth=(WARMUP, TIMED)):
    """bench.py's protocol at another depth: depth = (warm-up, timed) steps,
    the timed ones on the host clock, fenced by synchronize. Returns
    (seconds per step, last loss)."""
    warmup, timed = depth
    for _ in range(warmup):
        step(state, x, y, generator=gen)
    sync()
    t0 = time.perf_counter()
    for _ in range(timed):
        loss, _ = step(state, x, y, generator=gen)
    sync()
    return (time.perf_counter() - t0) / timed, loss


def steps_in_turns(label, turns, x, y, gen, failures, want=None, depth=(WARMUP, TIMED),
                   path=None, routes=()):
    """Train steps in turns on one card (a, b, b, a), each run timed_steps
    at `depth`: turns maps a name to (state, step, context), context()
    wrapping its runs (plain_kernels for the plain path). Each run's
    launches per step must equal want[name] where it is given, and are added
    to path; the runs of the names in `routes` must keep every window
    kernel on the vector route (check_routes, read just after the run).
    Returns {name: {"seconds": [per step, each run], "peak": bytes,
    "launches": [each run's]}}."""
    import torch

    from convnets_tpu_torch.ops import kernels

    names = list(turns)
    out = {name: {"seconds": [], "peak": 0, "launches": []} for name in names}
    for name in (names[0], names[1], names[1], names[0]):
        state, step, context = turns[name]
        r = out[name]
        sync()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        with context():
            seconds, loss = timed_steps(step, state, x, y, gen, depth)
        r["seconds"].append(seconds)
        r["peak"] = max(r["peak"], torch.cuda.max_memory_allocated())
        r["launches"].append(dict(kernels.LAUNCHES))
        if name in routes:
            check_routes(f"{label} run", r["launches"][-1], failures)
        if path is not None:
            for k, v in r["launches"][-1].items():
                path[k] = path.get(k, 0) + v
        per_step = {k: v / sum(depth) for k, v in r["launches"][-1].items()}
        if want is not None and name in want and per_step != want[name]:
            failures.append(f"{label} {name} launches per step {launches_summary(per_step)} != "
                            f"{launches_summary(want[name])}")
        if not bool(torch.isfinite(loss)):
            failures.append(f"{label} {name}: loss {float(loss)}")
    return out


def train_throughput(arch, seed, failures, depth=(WARMUP, TIMED)):
    """bench.py's train step at TRAIN_BATCH[arch], bf16, kernel and plain
    paths in turns on one model, `depth` steps a run; returns (launches of
    one kernel run, img/s)."""
    import torch

    batch = TRAIN_BATCH[arch]
    model = make_model(arch, seed, True)
    gflop_train = 3 * (forward_gflop(model) + forward_linear_gflop(model))
    state, step = train_state(model)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randint(0, 256, (batch, IMAGE, IMAGE, 3), dtype=torch.uint8, device=DEVICE,
                      generator=gen)
    y = torch.randint(0, 1000, (batch,), device=DEVICE, generator=gen)
    want = launches_of(TRAIN_LAUNCHES[arch])
    label = f"{arch} b{batch} train"
    runs = steps_in_turns(label, {"plain": (state, step, plain_kernels),
                                  "kernel": (state, step, contextlib.nullcontext)},
                          x, y, gen, failures, {"kernel": want}, depth, routes=("kernel",))
    launch_runs = runs["kernel"]["launches"]
    dt, dt_plain = (float(np.mean(runs[p]["seconds"])) for p in ("kernel", "plain"))
    rate = batch / dt
    say(f"(iii/iv) train {arch}@224 bf16 b{batch} (Adam, wd 1e-4, dropout 0.5, uint8 batch on "
        f"the card): kernel path {rate:.1f} img/s ({1e3 * dt:.2f} ms/step; runs "
        f"{[round(1e3 * t, 2) for t in runs['kernel']['seconds']]} ms), plain path "
        f"{batch / dt_plain:.1f} img/s ({1e3 * dt_plain:.2f} ms/step; runs "
        f"{[round(1e3 * t, 2) for t in runs['plain']['seconds']]} ms); peak memory (kernel "
        f"path) {runs['kernel']['peak'] / 2 ** 30:.2f} GiB; {rate * gflop_train / 1e3:.2f} "
        f"TFLOP/s of model arithmetic ({gflop_train:.3f} GFLOP/img: 3 × the forward convs and "
        f"classifier)")
    say(f"    launches per kernel run of {sum(depth)} steps ({depth[0]} warm-up, {depth[1]} "
        f"timed): {launch_runs} (per step expected {want})")
    print_train_profile(arch, step, state, x, y, gen)
    return launch_runs[0], rate


def device_split(prof, ours):
    """(all device µs, µs of device events whose name has one of `ours`,
    device µs under aten::convolution_backward) of a profile."""
    from torch.autograd import DeviceType

    def dev(e):
        t = getattr(e, "device_time_total", None)
        return float(e.cuda_time_total if t is None else t)

    events = prof.events()
    kernels = [e for e in events if getattr(e, "device_type", None) == DeviceType.CUDA]
    total = sum(dev(e) for e in kernels)
    mine = sum(dev(e) for e in kernels if any(n in e.name for n in ours))
    bwd = sum(dev(e) for e in events if e.name == "aten::convolution_backward")
    return total, mine, bwd


def window_shares(prof, total_us, per):
    """Device ms per request or step (`per` of them traced) of each group of
    WINDOW_KERNELS, and its share of `total_us`."""
    parts = []
    for label, names in WINDOW_KERNELS:
        us = device_split(prof, names)[1]
        parts.append(f"{label} {us / per / 1e3:.4f} ms ({100 * us / max(total_us, 1e-9):.2f}%)")
    return ", ".join(parts)


def print_table(prof, what):
    say(f"profile ({what}, sorted by device time):")
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=18)
    for line in table.splitlines():
        say("  " + line)


def print_train_profile(arch, step, state, x, y, gen):
    """torch.profiler over 3 train steps: device time of the port's forward
    kernels, of the backward convs (aten::convolution_backward), and the rest."""
    from torch.profiler import ProfilerActivity, profile

    step(state, x, y, generator=gen)
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(state, x, y, generator=gen)
        sync()
    host = time.perf_counter() - t0
    print_table(prof, f"{arch} train b{x.shape[0]} x 3")
    device, ours, bwd = device_split(prof, OUR_KERNELS)
    grouped = device_split(prof, GROUPED_KERNELS)[1]
    say(f"{arch} train device time over 3 steps: {device / 1e3:.3f} ms (host clock under the "
        f"profiler {1e3 * host:.1f} ms); the port's kernels "
        f"({', '.join(OUR_KERNELS)}) {ours / 1e3:.3f} ms "
        f"({100 * ours / max(device, 1e-9):.2f}%; of them the grouped conv "
        f"{grouped / 1e3:.3f} ms, {100 * grouped / max(device, 1e-9):.2f}%); backward convs "
        f"(aten::convolution_backward, cuDNN) {bwd / 1e3:.3f} ms "
        f"({100 * bwd / max(device, 1e-9):.2f}%); everything else "
        f"{(device - ours - bwd) / 1e3:.3f} ms")
    say(f"{arch} train b{x.shape[0]}, window kernels per step: {window_shares(prof, device, 3)}")


def serve_check(served, arch, seed, serve_batches, failures):
    """Serve the family's model that learn_check trained, on the images it
    learned, as uint8 requests; returns the launch counts of those
    requests."""
    import torch

    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.serve import ServingModel

    model, images, labels = served
    server = ServingModel(model, input_dtype="uint8", stats=IMAGENET_STATS)
    rng = np.random.default_rng(seed + 1)
    order = np.concatenate([np.arange(len(images))] * -(-max(serve_batches) // len(images)))
    requests = [images[order[:b]] for b in serve_batches]
    server(requests[0])  # first call: kernels loaded, allocator warm
    sync()

    kernels.reset_launches()
    outs = [server(r) for r in requests]
    sync()
    launches = dict(kernels.LAUNCHES)

    want = launches_of({k: v * len(serve_batches) for k, v in SERVE_LAUNCHES[arch].items()})
    say(f"{arch} served batches {serve_batches}: launches {launches} (expected {want})")
    if launches != want:
        failures.append(f"{arch} launch counts {launches} != {want}")
    check_routes(f"{arch} served batches {serve_batches}", launches, failures)
    for b, y in zip(serve_batches, outs):
        if tuple(y.shape) != (b, 1000) or y.dtype != torch.float32:
            failures.append(f"{arch} batch {b}: logits {tuple(y.shape)} {y.dtype}")
        if not bool(torch.isfinite(y).all()):
            failures.append(f"{arch} batch {b}: non-finite logits")

    with plain_kernels():
        refs = [server(r) for r in requests]
    sync()
    if dict(kernels.LAUNCHES) != launches:
        failures.append(f"{arch}: the plain comparison launched kernels")
    got = torch.cat([o.argmax(-1) for o in outs])
    ref = torch.cat([o.argmax(-1) for o in refs])
    agree = float((got == ref).float().mean())
    diff = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
    scale = max(float(r.abs().max()) for r in refs)
    top2 = torch.cat([r.topk(2, dim=-1).values for r in refs])
    gap = float((top2[:, 0] - top2[:, 1]).min())
    learned = float((got.cpu() == torch.from_numpy(labels[np.concatenate(
        [order[:b] for b in serve_batches])]).long()).float().mean())
    say(f"bf16 serving of the trained {arch} vs plain on the card: argmax agreement "
        f"{agree:.4f} over {got.numel()} images (min {ARGMAX_MIN}); distinct argmax classes "
        f"{ref.unique().numel()} (plain) / {got.unique().numel()} (kernel); served class = "
        f"learned label for {learned:.4f} of them; smallest top-2 gap {gap:.4e}, max |logit "
        f"diff| {diff:.4e} (max |logit| {scale:.4e})")
    if agree < ARGMAX_MIN:
        failures.append(f"{arch} argmax agreement {agree:.4f} < {ARGMAX_MIN}")

    # the same network in fp32 (TF32 off): kernel path vs plain path, tight
    model32 = make_model(arch, seed, False)
    x = torch.from_numpy(images[:8]).to(DEVICE).float() / 255.0
    with torch.inference_mode():
        y32 = model32(x)
        with plain_kernels():
            r32 = model32(x)
    rel = float((y32 - r32).abs().max() / r32.abs().max())
    say(f"fp32 {arch} forward (batch 8) vs plain: max |diff| / max |logit| = {rel:.3e} (tol 1e-4)")
    if not (rel <= 1e-4 and bool(torch.isfinite(y32).all())):
        failures.append(f"fp32 {arch} relative diff {rel:.3e}")
    del model32

    def seconds_per_batch(req, iters=10):
        for _ in range(2):
            server(req)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            server(req)
        sync()
        return (time.perf_counter() - t0) / iters

    for b in THROUGHPUT_BATCHES[arch]:
        req = rng.integers(0, 256, (b, IMAGE, IMAGE, 3), dtype=np.uint8)
        runs = {"kernel": [], "plain": []}
        for path in ("plain", "kernel", "kernel", "plain"):  # in turns, one card
            with plain_kernels() if path == "plain" else contextlib.nullcontext():
                runs[path].append(seconds_per_batch(req))
        dt, dt_plain = (float(np.mean(runs[p])) for p in ("kernel", "plain"))
        say(f"serving {arch}@224 bf16, uint8 requests from host, batch {b}: "
            f"{b / dt:.1f} img/s ({1e3 * dt:.2f} ms/batch; runs "
            f"{[round(1e3 * t, 2) for t in runs['kernel']]} ms); through the plain "
            f"versions {b / dt_plain:.1f} img/s ({1e3 * dt_plain:.2f} ms/batch)")

    from torch.profiler import ProfilerActivity, profile

    req = rng.integers(0, 256, (64, IMAGE, IMAGE, 3), dtype=np.uint8)
    server(req)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            server(req)
        sync()
    print_table(prof, f"{arch} serving batch 64 x 3")
    copies = h2d_copies(prof)
    device, ours = device_split(prof, OUR_KERNELS)[:2]
    grouped = device_split(prof, GROUPED_KERNELS)[1]
    # the trace may miss a request's copy (its kernels are all there): a
    # request's device time is its share of the kernels plus one copy
    copy_us = float(np.mean([us for _, us in copies])) if copies else 0.0
    request_us = (device - sum(us for _, us in copies)) / 3 + copy_us
    say(f"{arch} serving batch 64: host-to-device copies traced over 3 requests: "
        f"{len(copies)}, bytes each {sorted({b for b, _ in copies})} (the uint8 request is "
        f"{req.nbytes}; as fp32 it would be {4 * req.nbytes}); {copy_us / 1e3:.3f} ms per copy, "
        f"{100 * copy_us / max(request_us, 1e-9):.2f}% of a request's device time "
        f"({request_us / 1e3:.3f} ms); the port's kernels {ours / 3e3:.3f} ms per request (of "
        f"them the grouped conv {grouped / 3e3:.3f} ms)")
    say(f"{arch} serving batch 64, window kernels per request: "
        f"{window_shares(prof, 3 * request_us, 3)}")
    if not copies or any(b != req.nbytes for b, _ in copies):
        failures.append(f"{arch} serving: host-to-device copies of {[b for b, _ in copies]} bytes "
                        f"for a {req.nbytes}-byte uint8 request")
    return launches


def h2d_copies(prof):
    """[(bytes, device µs)] of each host-to-device copy in a profile, read
    from its Chrome trace (the memcpy events' "bytes")."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    return [(int(e.get("args", {}).get("bytes", 0)), float(e.get("dur", 0))) for e in copies]


def profiled_epoch(run):
    """run() under torch.profiler (device activity); returns (profile, host
    seconds of run, the bytes of each host-to-device copy the trace
    recorded, the host's memcpy calls (cudaMemcpyAsync) before the first
    CUDA-graph launch, between the first and the last, and after the
    last). The trace can miss the device's records of a replayed epoch's
    two small pinned copies (it missed both in full runs, among the
    graph's device-to-device copies), while the host's runtime calls are
    there, so the calls say when the copies were made."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        run()
        host = time.perf_counter() - t0
        sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    copies = [int(e.get("args", {}).get("bytes", 0)) for e in events
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    calls = [e for e in events if e.get("cat") == "cuda_runtime"]
    launches = [float(e["ts"]) for e in calls if "GraphLaunch" in e.get("name", "")]
    memcpys = [float(e["ts"]) for e in calls if "Memcpy" in e.get("name", "")]
    if not launches:
        return prof, host, copies, (len(memcpys), 0, 0)
    first, last = min(launches), max(launches)
    return prof, host, copies, (sum(t < first for t in memcpys),
                                sum(first < t < last for t in memcpys),
                                sum(t > last for t in memcpys))


def copies_ok(copies, calls, matrix_bytes) -> bool:
    """A replayed epoch's copies as profiled_epoch read them: the host's
    two memcpy calls before the first replay (the index and weight
    matrices), none during the replays, two after (the losses and correct
    counts read back), and every host-to-device copy the device recorded
    one of the matrices."""
    return calls == (2, 0, 2) and set(copies) <= {matrix_bytes} and len(copies) <= 2


def copies_text(copies, calls, matrix_bytes) -> str:
    return (f"the host's memcpy calls before / during / after the replays {calls} (want "
            f"(2, 0, 2): the index and weight matrices, {matrix_bytes} B each; the read-backs); "
            f"host-to-device copies the device recorded {len(copies)}, bytes "
            f"{sorted(set(copies))}")


def phase_family(arch, seed, failures, depth=(WARMUP, TIMED)):
    """Phase 7 for one family: (i) the fp32 step check, (ii) the bf16
    learning check, (iii) serving the model (ii) trained, (iv) bench.py's
    train step. Returns (serving launches, train launches)."""
    from convnets_tpu_torch.models import build_model

    probe = build_model(arch, model_setting(arch, seed, True), device=DEVICE)
    say(f"{arch}@224: forward convs {forward_gflop(probe):.4f} GFLOP/img, classifier "
        f"{forward_linear_gflop(probe):.4f} (mul+add = 2)")
    del probe
    step_check(arch, seed, failures)
    served = learn_check(arch, seed, failures)
    serve_launches = serve_check(served, arch, seed, ZOO_SERVE_BATCHES, failures)
    del served
    train_launches, _ = train_throughput(arch, seed, failures, depth)
    return serve_launches, train_launches


def grouped_shapes():
    """{(H, W, Cin, Cout, k, stride, pad, groups): [relu flag of each layer]}
    of ResNeXt-50@224's grouped convs (7 shapes, 16 layers), from its own
    modules."""
    from convnets_tpu_torch.models import build_model

    model = build_model("resnext", model_setting("resnext", 0, True, kind=GROUPED_SHAPES_KIND),
                        device=DEVICE)
    return distinct_shapes(model, ("gconv",))


def grouped_check(x, wt, groups, scale, shift, s, p, dname):
    """Both grouped epilogues against their plain versions on one input:
    (ok, fused y err relu=0 / 1, stats ok, stats y err, Σ err, Σ² err), the
    sums against those of the kernel's own stored y (stats_check)."""
    import torch

    from convnets_tpu_torch.ops import kernels

    atol, rtol = CONV_TOL[dname]
    errs, ok = [], True
    for relu in (False, True):
        kw = dict(stride=s, padding=p, relu=relu)
        got = kernels.grouped_conv2d_fused(x, wt, groups, scale, shift, **kw)
        ref = kernels.grouped_conv2d_fused_plain(x, wt, groups, scale, shift, **kw)
        sync()
        errs.append(float((got.float() - ref.float()).abs().max()))
        ok = ok and within(got, ref, atol, rtol) and bool(torch.isfinite(got).all())
        del got, ref
    kw = dict(stride=s, padding=p)
    s_ok, y_err, e1, e2 = stats_check(kernels.grouped_conv2d_stats(x, wt, groups, **kw),
                                      kernels.grouped_conv2d_stats_plain(x, wt, groups, **kw),
                                      dname, own=True)
    return ok, errs, s_ok, y_err, e1, e2


def grouped_route_ms(x, wt, groups, scale, shift, s, p, relu, route, reps=REPS, dilation=1):
    """Device ms of grouped_conv2d_fused (scale/shift, `relu`) and of
    grouped_conv2d_stats with their main loop forced to `route`, through
    the wrappers' launch path (the library refuses a route not built for
    the shape)."""
    from convnets_tpu_torch.ops.kernels import conv as kconv

    f_ms = time_ms(lambda: kconv._launch_fused("grouped_conv2d_fused", x, wt, scale, shift, s,
                                               p, relu, groups, route, dilation), reps)
    s_ms = time_ms(lambda: kconv._launch_stats("grouped_conv2d_stats", x, wt, s, p, groups,
                                               route, dilation), reps)
    return f_ms, s_ms


def phase_grouped_kernels(failures):
    """Phase 8, grouped conv: the plan of every distinct ResNeXt-50@224
    grouped shape (bf16 wgmma, fp32 simt); both epilogues at each at batch
    8, fp32 and bf16, with the bf16 simt route timed beside; both
    epilogues at every branch of grouped_plan (GROUPED_PLAN_SHAPES); and
    the two trainable grouped functions at a stride-1 and a stride-2
    shape."""
    import torch
    import torch.nn.functional as F

    from convnets_tpu_torch.ops import kernels

    distinct = grouped_shapes()
    n_layers = sum(len(v) for v in distinct.values())
    if (len(distinct), n_layers) != (7, GROUPED_SHAPES_LAYERS):
        failures.append(f"ResNeXt-50 walk found {len(distinct)} grouped shapes ({n_layers} layers)")
    rows = kernels.lib().grouped_block_rows()
    if rows != kernels.GroupedPlan("wgmma", 4).bm:
        failures.append(f"grouped_block_rows() {rows} != the plans' 128 rows per partial")
    g = torch.Generator(device=DEVICE).manual_seed(3)
    n = KERNEL_BATCH
    summary = {}
    fused_row = entry(summary, "grouped_conv2d_fused")
    stats_row = entry(summary, "grouped_conv2d_stats")
    for row in (fused_row, stats_row):
        row["simt_ms"] = 0.0
    say("grouped conv (N=8): H W Cin Cout k s p G | dtype route | fused y err, relu=0 / 1 (tol) | "
        "stats y err, Σ rel, Σ² rel vs own y (tol) | fused kernel_ms plain_ms simt_ms, stats "
        "kernel_ms plain_ms simt_ms, cudnn_bf16_ms | uses")
    for (h, w, cin, cout, k, s, p, groups), relus in sorted(distinct.items()):
        cg = cin // groups
        x32 = torch.randn(n, h, w, cin, device=DEVICE, generator=g)
        w32 = torch.randn(k, k, cg, cout, device=DEVICE, generator=g) / np.sqrt(k * k * cg)
        scale = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        shift = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        xc, wc = nchw(x32.to(torch.bfloat16)), oihw(w32.to(torch.bfloat16))
        cudnn_ms = time_ms(lambda: F.conv2d(xc, wc, stride=s, padding=p, groups=groups), REPS)
        for dtype in (torch.float32, torch.bfloat16):
            dname = dname_of(dtype)
            atol, rtol = CONV_TOL[dname]
            x, wt = x32.to(dtype).contiguous(), w32.to(dtype).contiguous()
            plan = kernels.grouped_plan(dtype, cin, cout, groups)
            want = "wgmma" if dtype == torch.bfloat16 else "simt"
            ok, errs, s_ok, y_err, e1, e2 = grouped_check(x, wt, groups, scale, shift, s, p, dname)
            ok = ok and plan.route == want
            relu = relus[0]
            fk, sk = grouped_route_ms(x, wt, groups, scale, shift, s, p, relu, plan.route)
            fp = time_ms(lambda: kernels.grouped_conv2d_fused_plain(
                x, wt, groups, scale, shift, stride=s, padding=p, relu=relu), REPS)
            sp = time_ms(lambda: kernels.grouped_conv2d_stats_plain(x, wt, groups, stride=s,
                                                                    padding=p), REPS)
            fs, ss = (grouped_route_ms(x, wt, groups, scale, shift, s, p, relu, "simt")
                      if plan.route == "wgmma" else (fk, sk))
            say(f"  {h} {w} {cin} {cout} {k} {s} {p} {groups} | {dname} {plan.route} | "
                f"{errs[0]:.3e} / {errs[1]:.3e} ({atol:g}+{rtol:g}|ref|) {'ok' if ok else 'FAIL'} | "
                f"{y_err:.3e}, {e1:.2e}, {e2:.2e} ({STATS_TOL[dname]:g}) "
                f"{'ok' if s_ok else 'FAIL'} | {fk:.4f} {fp:.4f} {fs:.4f}, {sk:.4f} {sp:.4f} "
                f"{ss:.4f}, {cudnn_ms:.4f} | {len(relus)}")
            if not (ok and s_ok):
                failures.append(f"grouped conv {h}x{w} {cin}->{cout} s{s} G{groups} {dname} "
                                f"{plan.route} (want {want}): fused {errs}, stats y {y_err:.3e} "
                                f"Σ {e1:.2e} Σ² {e2:.2e}")
            fused_row["err"] = max(fused_row["err"], *errs)
            stats_row["err"] = max(stats_row["err"], y_err)
            if dtype == torch.bfloat16:
                flops, nbytes = conv_work(n, h, w, cin, cout, k, s, p, groups)
                add_times(fused_row, len(relus), fk, fp, flops, nbytes + 8 * cout, cudnn_ms)
                add_times(stats_row, len(relus), sk, sp, flops, nbytes + 8 * cout, cudnn_ms)
                fused_row["simt_ms"] += len(relus) * fs
                stats_row["simt_ms"] += len(relus) * ss
            del x, wt
    say(f"ResNeXt-50 grouped convs at N=8 bf16, summed over the 16 layers: fused kernel "
        f"{fused_row['ms']:.4f} ms (plain {fused_row['plain_ms']:.4f}, simt route "
        f"{fused_row['simt_ms']:.4f}), stats kernel {stats_row['ms']:.4f} ms (plain "
        f"{stats_row['plain_ms']:.4f}, simt route {stats_row['simt_ms']:.4f}), cuDNN bf16 "
        f"grouped conv {fused_row['library_ms']:.4f} ms, bound {fused_row['bound_ms']:.4f} ms")

    gp = torch.Generator(device=DEVICE).manual_seed(8)
    say("grouped plans: N H W Cin Cout G k s p | dtype route | fused y err, relu=0 / 1 (tol) | "
        "stats y err, Σ rel, Σ² rel vs own y (tol) | what")
    for n_, h, w, cin, cout, groups, k, s, p, route, what in GROUPED_PLAN_SHAPES:
        cg = cin // groups
        x32 = torch.randn(n_, h, w, cin, device=DEVICE, generator=gp)
        w32 = torch.randn(k, k, cg, cout, device=DEVICE, generator=gp) / np.sqrt(k * k * cg)
        scale = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=gp)
        shift = 0.1 * torch.randn(cout, device=DEVICE, generator=gp)
        for dtype in (torch.float32, torch.bfloat16):
            dname = dname_of(dtype)
            atol, rtol = CONV_TOL[dname]
            plan = kernels.grouped_plan(dtype, cin, cout, groups)
            want = route if dtype == torch.bfloat16 else "simt"
            ok, errs, s_ok, y_err, e1, e2 = grouped_check(x32.to(dtype), w32.to(dtype), groups,
                                                          scale, shift, s, p, dname)
            ok = ok and plan.route == want
            say(f"  {n_} {h} {w} {cin} {cout} {groups} {k} {s} {p} | {dname} {plan.route} | "
                f"{errs[0]:.3e} / {errs[1]:.3e} ({atol:g}+{rtol:g}|ref|) {'ok' if ok else 'FAIL'} | "
                f"{y_err:.3e}, {e1:.2e}, {e2:.2e} ({STATS_TOL[dname]:g}) "
                f"{'ok' if s_ok else 'FAIL'} | {what}")
            if not (ok and s_ok):
                failures.append(f"grouped plan {what} {dname} {plan.route} (want {want}): fused "
                                f"{errs}, stats y {y_err:.3e} Σ {e1:.2e} Σ² {e2:.2e}")
            fused_row["err"] = max(fused_row["err"], *errs)
            stats_row["err"] = max(stats_row["err"], y_err)

    say("trainable grouped functions (N=8): fn H Cin Cout s G | dtype | out max|Δ|/max|ref| "
        "(tol) | gradients ‖Δ‖/‖g‖ (tol) [max|Δ|/max|g|] | ReLU mask flips | fwd+bwd "
        "kernel_ms plain_ms library_ms")
    groups = 32
    for h, c, s in ((IMAGE // 4, 128, 1), (IMAGE // 4, 256, 2)):
        x32 = torch.randn(n, h, h, c, device=DEVICE, generator=g)
        w32 = torch.randn(3, 3, c // groups, c, device=DEVICE, generator=g) / np.sqrt(9 * c // groups)
        sc32 = 1.0 + 0.1 * torch.randn(c, device=DEVICE, generator=g)
        bi32 = 0.1 * torch.randn(c, device=DEVICE, generator=g)
        work = conv_train_work(n, h, h, c, c, 3, s, 1, groups)
        for dtype in (torch.float32, torch.bfloat16):
            dname = dname_of(dtype)
            x, wt = x32.to(dtype), w32.to(dtype)
            label = f"{h} {c} {c} {s} {groups}"
            check_trainable("grouped_conv2d_train", label,
                            lambda a, b: kernels.grouped_conv2d_train(a, b, groups, s, 1),
                            [x, wt], dname, g, summary, failures, CONV_TOL[dname][1], work,
                            conv_lib(s, 1, groups))
            check_trainable("conv_bn_relu_train_grouped", label,
                            lambda a, b, c_, d: kernels.conv_bn_relu_train(
                                a, b, c_, d, s, 1, groups=groups)[0],
                            [x, wt, sc32, bi32], dname, g, summary, failures,
                            CONV_TOL[dname][1], work)
    return summary


def phase_b256_grouped(summary):
    """Phase 8b: rows 1g and 5g in bf16 at batch B256 at every distinct
    ResNeXt-50@224 grouped shape, and row 8's forward (grouped_conv2d_fused
    with no epilogue): the wgmma route, the simt route on the same inputs,
    cuDNN's bf16 grouped F.conv2d (channels_last) and the bound, each
    summed by layer use into the rows' ms_b256, simt_ms_b256,
    library_ms_b256 and bound_ms_b256."""
    import torch
    import torch.nn.functional as F

    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.ops.kernels import conv as kconv

    g = torch.Generator(device=DEVICE).manual_seed(9)
    fused, stats = summary["grouped_conv2d_fused"], summary["grouped_conv2d_stats"]
    train = entry(summary, "grouped_conv2d_train")
    for row in (fused, stats, train):
        row.update(dict.fromkeys(B256_KEYS + ("simt_ms_b256",), 0.0))
    total = total_bytes = 0
    say(f"grouped conv at batch {B256}, bf16: H W Cin Cout k s p G | route | fused ms TFLOP/s | "
        f"stats ms TFLOP/s | no epilogue (row 8's forward) ms | simt route: fused ms, stats ms, "
        f"no epilogue ms | cuDNN ms TFLOP/s | bound ms | uses")
    for (h, w, cin, cout, k, s, p, groups), relus in sorted(grouped_shapes().items()):
        cg = cin // groups
        x = torch.randn(B256, h, w, cin, device=DEVICE, generator=g).to(torch.bfloat16)
        wt = (torch.randn(k, k, cg, cout, device=DEVICE, generator=g)
              / np.sqrt(k * k * cg)).to(torch.bfloat16)
        scale = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        shift = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        xc, wc = nchw(x), oihw(wt)
        plan = kernels.grouped_plan(torch.bfloat16, cin, cout, groups)
        times = {}
        for route in (plan.route, "simt"):
            f_ms, s_ms = grouped_route_ms(x, wt, groups, scale, shift, s, p, True, route)
            t_ms = time_ms(lambda: kconv._launch_fused("grouped_conv2d_fused", x, wt, None, None,
                                                       s, p, False, groups, route), REPS)
            times[route] = (f_ms, s_ms, t_ms)
        c_ms = time_ms(lambda: F.conv2d(xc, wc, stride=s, padding=p, groups=groups), REPS)
        flops, nbytes = conv_work(B256, h, w, cin, cout, k, s, p, groups)
        bound = 1e3 * max(flops / PEAK_BF16, (nbytes + 8 * cout) / HBM_BPS)
        uses = len(relus)
        total += uses * flops
        total_bytes += uses * nbytes
        (f_ms, s_ms, t_ms), simt = times[plan.route], times["simt"]
        say(f"  {h} {w} {cin} {cout} {k} {s} {p} {groups} | {plan.route} | "
            f"{f_ms:.4f} {flops / f_ms / 1e9:.1f} | {s_ms:.4f} {flops / s_ms / 1e9:.1f} | "
            f"{t_ms:.4f} | {simt[0]:.4f}, {simt[1]:.4f}, {simt[2]:.4f} | "
            f"{c_ms:.4f} {flops / c_ms / 1e9:.1f} | {bound:.4f} | {uses}")
        for row, ms, sm in ((fused, f_ms, simt[0]), (stats, s_ms, simt[1]), (train, t_ms, simt[2])):
            row["ms_b256"] += uses * ms
            row["simt_ms_b256"] += uses * sm
            row["library_ms_b256"] += uses * c_ms
            row["bound_ms_b256"] += uses * bound
        del x, wt, xc, wc
    lib_ms = fused["library_ms_b256"]
    say(f"ResNeXt-50 grouped convs at b{B256} bf16, summed over the 16 layers ({total / 1e9:.1f} "
        f"GFLOP, {total_bytes / 1e9:.3f} GB): grouped_conv2d_fused {fused['ms_b256']:.3f} ms "
        f"({total / fused['ms_b256'] / 1e9:.1f} TFLOP/s, {fused['ms_b256'] / lib_ms:.3f}x cuDNN; "
        f"simt route {fused['simt_ms_b256']:.3f} ms), grouped_conv2d_stats {stats['ms_b256']:.3f} "
        f"ms ({stats['ms_b256'] / lib_ms:.3f}x cuDNN; simt route {stats['simt_ms_b256']:.3f} ms), "
        f"no epilogue {train['ms_b256']:.3f} ms (simt route {train['simt_ms_b256']:.3f}), cuDNN "
        f"bf16 {lib_ms:.3f} ms ({total / lib_ms / 1e9:.1f} TFLOP/s), bound "
        f"{fused['bound_ms_b256']:.4f} ms")


def block_args(n, h, cin, cmid, dtype, g):
    """A random identity bottleneck of tpu_block_ab.py's construction: x,
    w1 (Cin, Cmid), s1, b1, w2 (3, 3, Cmid, Cmid), s2, b2, w3 (Cmid, Cin),
    s3, b3; weights in `dtype`, scales U(0.9, 1.1), shifts N(0, 0.01)."""
    import torch

    def rnd(*shape):
        return torch.randn(*shape, device=DEVICE, generator=g)

    def uni(c):
        return 0.9 + 0.2 * torch.rand(c, device=DEVICE, generator=g)

    return [rnd(n, h, h, cin).to(dtype), (rnd(cin, cmid) / np.sqrt(cin)).to(dtype), uni(cmid),
            0.01 * rnd(cmid), (rnd(3, 3, cmid, cmid) / np.sqrt(9 * cmid)).to(dtype), uni(cmid),
            0.01 * rnd(cmid), (rnd(cmid, cin) / np.sqrt(cmid)).to(dtype), uni(cin),
            0.01 * rnd(cin)]


def block_work(n, h, cin, cmid):
    """(FLOPs, bytes) of one bf16 block: three products; x and the weights
    read once, out written once (h1 and h2 stay on chip)."""
    flops = 2 * n * h * h * (2 * cin * cmid + 9 * cmid * cmid)
    return flops, 2 * (2 * n * h * h * cin + 2 * cin * cmid + 9 * cmid * cmid)


def serving_composition(x, w1, s1, b1, w2, s2, b2, w3, s3, b3):
    """The block as the port serves RN50 today: three conv2d_fused launches
    (BN folded into their epilogues), the residual add and the ReLU in
    x.dtype."""
    from convnets_tpu_torch.ops import kernels

    cin, cmid = w1.shape
    h1 = kernels.conv2d_fused(x, w1.reshape(1, 1, cin, cmid), s1, b1, relu=True)
    h2 = kernels.conv2d_fused(h1, w2, s2, b2, padding=1, relu=True)
    y = kernels.conv2d_fused(h2, w3.reshape(1, 1, cmid, cin), s3, b3)
    return (y + x).clamp_min(0)


def cudnn_composition(x, w1, s1, b1, w2, s2, b2, w3, s3, b3):
    """The same block through three cuDNN bf16 convs (channels_last) and
    eager epilogues: a library yardstick, never the port's path."""
    import torch.nn.functional as F

    cin, cmid = w1.shape
    xc = nchw(x)

    def bn(y, sc, sh):
        return y * sc.view(1, -1, 1, 1).to(y.dtype) + sh.view(1, -1, 1, 1).to(y.dtype)

    h1 = bn(F.conv2d(xc, oihw(w1.reshape(1, 1, cin, cmid))), s1, b1).clamp_min(0)
    h2 = bn(F.conv2d(h1, oihw(w2), padding=1), s2, b2).clamp_min(0)
    out = (bn(F.conv2d(h2, oihw(w3.reshape(1, 1, cmid, cin))), s3, b3) + xc).clamp_min(0)
    return out.permute(0, 2, 3, 1)  # NHWC, channels_last in memory


def block_route_launches():
    """(wgmma, simt) launches of bottleneck_block since the last reset."""
    from convnets_tpu_torch.ops import kernels

    routes = kernels.ROUTE_LAUNCHES["bottleneck_block"]
    return routes["wgmma"], routes["simt"]


def phase_block(failures):
    """Phase 8, bottleneck_block: checked against its plain version at
    batch 8 on each route, then the A/B of scripts/tpu_block_ab.py at
    batch 256 (chains of 6 and 4 blocks). Returns (summary, launches of
    the kernel arm's timed chains)."""
    import torch

    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.ops.kernels import block as kblock

    g = torch.Generator(device=DEVICE).manual_seed(4)
    summary = {}
    row = entry(summary, "bottleneck_block")

    def simt(*args, relu_out=True):
        return kblock._launch_block(*args, relu_out=relu_out, route="simt")

    def check(label, args, want_route, relu_out=True, against_simt=False):
        dname = dname_of(args[0].dtype)
        n, h, w, cin = args[0].shape
        plan = kernels.block_plan(args[0].dtype, n, h, w, cin, args[1].shape[1])
        sync()
        kernels.reset_launches()
        got = kernels.bottleneck_block(*args, relu_out=relu_out)
        sync()
        routes = block_route_launches()
        ref = kernels.bottleneck_block_plain(*args, relu_out=relu_out)
        err = float((got.float() - ref.float()).abs().max())
        atol, rtol = BLOCK_TOL[dname]
        ok = (within(got, ref, atol, rtol) and bool(torch.isfinite(got).all())
              and plan.route == want_route
              and routes == ((1, 0) if want_route == "wgmma" else (0, 1)))
        line = (f"  {label} | {dname} {plan.route} th={plan.th} | {err:.3e} "
                f"({atol:g}+{rtol:g}|ref|)")
        if against_simt:
            other = simt(*args, relu_out=relu_out)
            sync()
            s_err = float((got.float() - other.float()).abs().max())
            s_ok = within(got, other, atol, rtol)
            ok = ok and s_ok
            line += f" | vs simt {s_err:.3e}"
        say(line + (" ok" if ok else f" FAIL (launches wgmma/simt {routes})"))
        if not ok:
            failures.append(f"bottleneck_block {label} {dname}: err {err:.3e}, route "
                            f"{plan.route} (want {want_route}), launches {routes}")
        row["err"] = max(row["err"], err)
        return got

    say("bottleneck_block (N=8): H Cin Cmid | dtype route | max_abs_err (tol) | vs simt | "
        "kernel_ms plain_ms simt_ms")
    for h, cin, cmid in BLOCK_CHECK_SHAPES:
        args32 = block_args(KERNEL_BATCH, h, cin, cmid, torch.float32, g)
        for dtype in (torch.float32, torch.bfloat16):
            args = [a.to(dtype) if i in (0, 1, 4, 7) else a for i, a in enumerate(args32)]
            bf = dtype == torch.bfloat16
            check(f"{h} {cin} {cmid}", args, "wgmma" if bf else "simt", against_simt=bf)
            k_ms = time_ms(lambda: kernels.bottleneck_block(*args), REPS)
            p_ms = time_ms(lambda: kernels.bottleneck_block_plain(*args), REPS)
            s_ms = time_ms(lambda: simt(*args), REPS) if bf else k_ms
            say(f"    {h} {cin} {cmid} {dname_of(dtype)}: {k_ms:.4f} {p_ms:.4f} {s_ms:.4f}")
    # the bf16 wgmma route without the final ReLU, and with a zero halo: W1 =
    # 0 and b1 > 0 make h1 = ReLU(b1) > 0 inside the image, which the 3x3
    # conv must not see outside it
    h, cin, cmid = BLOCK_CHECK_SHAPES[1]
    args = block_args(KERNEL_BATCH, h, cin, cmid, torch.bfloat16, g)
    check(f"{h} {cin} {cmid} relu_out=False", args, "wgmma", relu_out=False, against_simt=True)
    args[1] = torch.zeros_like(args[1])
    args[3] = args[3].abs() + 0.5
    args[0] = torch.zeros_like(args[0])
    got = check(f"{h} {cin} {cmid} zero halo", args, "wgmma", relu_out=False, against_simt=True)
    if torch.equal(got[:, 0, 0], got[:, h // 2, h // 2]):
        failures.append("bottleneck_block zero halo: a corner equals an interior pixel")
    h, cin, cmid = BLOCK_SIMT_SHAPE
    check(f"{h} {cin} {cmid} off the wgmma route", block_args(
        KERNEL_BATCH, h, cin, cmid, torch.bfloat16, g), "simt")

    # the A/B: each arm runs the chain of blocks RN50 runs at that shape
    arms = {"kernel": kernels.bottleneck_block, "simt": simt,
            "plain": kernels.bottleneck_block_plain, "serving": serving_composition,
            "cudnn": cudnn_composition}
    say(f"block A/B (scripts/tpu_block_ab.py's, batch {BLOCK_BATCH}, bf16): shape | arm "
        f"ms/chain TFLOP/s ratio-to-kernel")
    launches = 0
    for h, cin, cmid, chain in BLOCK_SHAPES:
        args = block_args(BLOCK_BATCH, h, cin, cmid, torch.bfloat16, g)

        def run(block):
            v = args[0]
            for _ in range(chain):
                v = block(v, *args[1:])
            return v

        times = {}
        for arm in ("plain", "kernel", "simt", "serving", "cudnn"):
            if arm == "kernel":
                sync()
                kernels.reset_launches()
            with torch.inference_mode():
                times[arm] = time_ms(lambda: run(arms[arm]), 3)
            if arm == "kernel":
                sync()
                n_arm = kernels.LAUNCHES["bottleneck_block"]
                launches += n_arm
                if block_route_launches() != (n_arm, 0):
                    failures.append(f"block A/B {h}x{cin}/{cmid}: kernel arm launches "
                                    f"(wgmma, simt) {block_route_launches()} of {n_arm}")
        flops, nbytes = block_work(BLOCK_BATCH, h, cin, cmid)
        for arm, ms in times.items():
            say(f"  {h}x{cin}/{cmid} x{chain} | {arm} {ms:.3f} {chain * flops / ms / 1e9:.2f} "
                f"{ms / times['kernel']:.3f}")
        add_times(row, chain, times["kernel"] / chain, times["plain"] / chain, flops, nbytes,
                  times["cudnn"] / chain)
        for key, arm in (("serving_ms", "serving"), ("simt_ms_b256", "simt")):
            row[key] = row.get(key, 0.0) + times[arm]
    return summary, launches


# phase 10: the Trainer on RN26@32 (CINIC-shaped), with bench.py:93-98's
# measure_pipeline settings without the augmentation (phase 11 runs it
# with the augmentation)
TRAINER_TRAIN, TRAINER_VALID, TRAINER_BATCH = 8192, 2048, 256
TRAINER_EPOCHS = 2  # (i); (ii) resumes for one more
TRAINER_MIN_ACC = 0.2  # (ii): valid accuracy, twice chance over 10 classes
# (iv): the fp32 epoch, kernel path against plain path, on a subset
SUBSET_TRAIN, SUBSET_VALID, SUBSET_BATCH = 1024, 512, 64
# (iv)'s bar: CONTROL_FACTOR × the plain fit against itself with its conv
# weights ×(1 + 1e-6·N(0,1)), and never looser than TRAINER_MAX_BAR. The
# fit's trajectory jumps under any rounding change (this check on the CPU
# with TRAINER_FP32_LR at 1e-4 moves the control's epoch loss by 3e-3, at
# 1e-3 by 1.5e-2): at a learning rate small enough for the 1e-2 bar, the
# epoch compares the fit loop and the forward. The gradients are held by
# (iv)'s one-step check, per leaf (STEP_GRAD_TOL), whose bar the plain
# path's bf16 gradients fall far outside.
TRAINER_CONTROL_PERTURBATION = 1e-6
TRAINER_FP32_LR = 1e-5
CONTROL_FACTOR = 10.0
TRAINER_MAX_BAR = 1e-2


def trainer_setting(seed, output_dir, **kw):
    """RN26@32, 10 classes, bf16: SGD lr 0.05 momentum 0.9, the
    per-example-mean objective, step decay every 2 epochs, normalization
    on, no augmentation, dropout 0.5, batch 256."""
    from convnets_tpu_torch.settings import Settings

    fields = dict(kind="26", input_size=(3, 32, 32), num_classes=10,
                  batch_size=TRAINER_BATCH, epochs=TRAINER_EPOCHS, mixed_precision=True,
                  data_augment=False, data_norm=True, optimizer="sgd", momentum=0.9,
                  learning_rate=0.05, loss_reduction="mean", lr_scheduler="step",
                  lr_step_size=2, dropout_rate=0.5, early_stop=False, seed=seed,
                  output_dir=output_dir)
    fields.update(kw)
    return Settings(**fields)


def trainer_data(seed):
    """(train, valid) uint8 ArrayDatasets of synthetic_dataset(learnable=True)
    from `seed`: 8,192 and 2,048 images at 32x32x3, 10 classes."""
    from convnets_tpu_torch.data import ArrayDataset, synthetic_dataset

    out = []
    for n, s in ((TRAINER_TRAIN, seed), (TRAINER_VALID, seed + 1)):
        ds = synthetic_dataset(n, (32, 32, 3), 10, seed=s, learnable=True)
        out.append(ArrayDataset((ds.images * 255).round().astype(np.uint8), ds.labels))
    return out


def conv_count(model) -> int:
    """The model's fused ConvBNReLUs, read off its modules (RN26: the stem,
    8 bottlenecks x 3 and 4 projection shortcuts)."""
    return sum(1 for l in model_layers(model) if l[0] == "conv")


def count_calls(trainer, record):
    """Record each train and eval step of `trainer` with its kernel launches
    (the LAUNCHES delta) into record["train"] / record["eval"]: the
    per-step routes' step calls, and each step of a replayed-graph epoch
    (train/graph.py StepGraph.step: an eager warm-up step's own launches,
    a replay's per-replay tally). The graphs' bodies are the same step
    functions, so a call made inside a graph step is not recorded again.
    While record.get("capture") is set, each per-step eval call's (x,
    predictions, weights) go to the host into record["eval_io"]."""
    from convnets_tpu_torch.ops import kernels

    inside = []

    def delta(before):
        return {n: kernels.LAUNCHES[n] - before[n] for n in before}

    def counted(kind, fn):
        def call(*a, **k):
            if inside:
                return fn(*a, **k)
            before = dict(kernels.LAUNCHES)
            out = fn(*a, **k)
            record[kind].append(delta(before))
            if kind == "eval" and record.get("capture"):
                record["eval_io"].append((a[0].cpu(), out[2].cpu(), a[2].cpu()))
            return out
        return call

    class CountedStep:
        """A TrainStep whose calls are recorded; its prepare / run (what a
        graph calls) pass through."""

        def __init__(self, step):
            self.step = step
            self.call = counted("train", step)

        def __getattr__(self, name):
            return getattr(self.step, name)

        def __call__(self, *a, **k):
            return self.call(*a, **k)

    def counted_graphs(kind, get):
        def getter(*args, **kwargs):
            graph = get(*args, **kwargs)
            if "step" not in vars(graph):  # not yet wrapped
                step = graph.step

                def graph_step(*a, **k):
                    before = dict(kernels.LAUNCHES)
                    inside.append(kind)
                    try:
                        step(*a, **k)
                    finally:
                        inside.pop()
                    record[kind].append(delta(before))
                graph.step = graph_step
            return graph
        return getter

    get_train, get_eval = trainer._get_train_step, trainer._get_eval_step
    trainer._get_train_step = lambda *a, **k: CountedStep(get_train(*a, **k))
    trainer._get_eval_step = lambda *a, **k: counted("eval", get_eval(*a, **k))
    trainer._get_train_epoch_fn = counted_graphs("train", trainer._get_train_epoch_fn)
    trainer._get_eval_epoch_fn = counted_graphs("eval", trainer._get_eval_epoch_fn)


@contextlib.contextmanager
def recorded_batches(batches):
    """Record (dtype, bytes, device type) of every x the Trainer's
    device_prefetch hands it."""
    from convnets_tpu_torch.train import engine

    feed = engine.device_prefetch

    def recording(*args, **kwargs):
        for x, y, w in feed(*args, **kwargs):
            batches.append((x.dtype, x.numel() * x.element_size(), x.device.type))
            yield x, y, w

    engine.device_prefetch = recording
    try:
        yield
    finally:
        engine.device_prefetch = feed


def timed_train_epochs(trainer, times):
    """Time each _run_train_epoch on the host clock; it ends by reading the
    epoch's loss sum back, which fences it."""
    run = trainer._run_train_epoch

    def timed(loader, epoch_index):
        t0 = time.perf_counter()
        out = run(loader, epoch_index)
        times.append(time.perf_counter() - t0)
        return out

    trainer._run_train_epoch = timed


# layer_check: a bf16 conv2d_stats call with fewer output rows per channel
# than this has its sums held against those of its own stored y, as phase
# 2a holds every shape (stats_check's `own`): at M = 32 one ulp of one y
# already moves Σ² by ~1e-3 of the plain version's
OWN_SUMS_ROWS = 128


def layer_check(label, models, runs, summary, failures):
    """Every distinct conv shape and every distinct max-pool shape of
    `models` (model_layers), at each (batch, dtype) of `runs`, each conv
    with the route conv_plan gives it: conv2d_fused with both epilogues and
    conv2d_stats against their plain versions with phase 2's and phase 4's
    bars (CONV_TOL, STATS_TOL; the sums of a bf16 call with fewer than
    OWN_SUMS_ROWS rows against the kernel's own y), and max_pool2d and
    pool2d_train (forward, and dx through pool2d_backward) exactly, each
    pool launch on the route pool_plan picks for its channels (vector where
    C % 8 == 0, else the loop). Each error goes into the kernels line's
    max_abs_err. Returns (distinct conv shapes, convs covered)."""
    import torch

    from convnets_tpu_torch.ops import kernels

    distinct, pools = {}, set()
    for model in models:
        for shape, relus in distinct_shapes(model).items():
            distinct.setdefault(shape, []).extend(relus)
        pools.update((h, w, c, k, s, p) for kind, h, w, c, _, k, s, p, _, _ in model_layers(model)
                     if kind == "maxpool")
    uses = sum(len(r) for r in distinct.values())
    if uses != sum(conv_count(m) for m in models):
        failures.append(f"{label} layer check covers {uses} of "
                        f"{sum(conv_count(m) for m in models)} convs")
    g = torch.Generator(device=DEVICE).manual_seed(10)
    rows = {name: entry(summary, name) for name in
            ("conv2d_fused", "conv2d_stats", "max_pool2d", "pool2d_train", "pool2d_backward")}
    say(f"{label} layers on the path: N H W Cin Cout k s p | dtype plan | fused y err relu=0 / 1 "
        "(tol) | stats y err, Σ rel, Σ² rel (tol) | uses")
    bad = 0
    for n, dtype in runs:
        dname = dname_of(dtype)
        atol, rtol = CONV_TOL[dname]
        for (h, w, cin, cout, k, s, p, _), relus in sorted(distinct.items()):
            x = torch.randn(n, h, w, cin, device=DEVICE, generator=g).to(dtype)
            wt = (torch.randn(k, k, cin, cout, device=DEVICE, generator=g)
                  / np.sqrt(k * k * cin)).to(dtype)
            scale = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
            shift = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
            m = n * conv_out_size(h, k, s, p) * conv_out_size(w, k, s, p)
            plan = kernels.conv_plan(dtype, m, cin, cout)
            ok = plan.route == ("wgmma" if dtype == torch.bfloat16 else "simt")
            errs = []
            for epi in (None, (scale, shift)):
                kw = dict(stride=s, padding=p, relu=epi is not None)
                got = kernels.conv2d_fused(x, wt, *(epi or ()), **kw)
                ref = kernels.conv2d_fused_plain(x, wt, *(epi or ()), **kw)
                sync()
                errs.append(float((got.float() - ref.float()).abs().max()))
                ok = ok and within(got, ref, atol, rtol) and bool(torch.isfinite(got).all())
            kw = dict(stride=s, padding=p)
            own = dtype == torch.bfloat16 and m < OWN_SUMS_ROWS
            s_ok, y_err, e1, e2 = stats_check(kernels.conv2d_stats(x, wt, **kw),
                                              kernels.conv2d_stats_plain(x, wt, **kw), dname,
                                              own=own)
            say(f"  {n} {h} {w} {cin} {cout} {k} {s} {p} | {dname} {plan.route} "
                f"{plan.bm}x{plan.bn} {plan.gather} | {errs[0]:.3e} / {errs[1]:.3e} "
                f"({atol:g}+{rtol:g}|ref|) {'ok' if ok else 'FAIL'} | {y_err:.3e}, {e1:.2e}, "
                f"{e2:.2e} ({STATS_TOL[dname]:g}{', own y' if own else ''}) "
                f"{'ok' if s_ok else 'FAIL'} | {len(relus)}")
            if not (ok and s_ok):
                bad += 1
                failures.append(f"{label} conv {n}x{h}x{w} {cin}->{cout} k{k} s{s} {dname} "
                                f"{plan.route}: fused {errs}, stats y {y_err:.3e} Σ {e1:.2e} "
                                f"Σ² {e2:.2e}")
            rows["conv2d_fused"]["err"] = max(rows["conv2d_fused"]["err"], *errs)
            rows["conv2d_stats"]["err"] = max(rows["conv2d_stats"]["err"], y_err)
            del x, wt
        # ties from the ReLU'd input; a cotangent of sixteenths, whose sums
        # over up to nine windows are exact in the fp32 accumulator both
        # sides round once
        for ph, pw, pc, pk, ps, pp in sorted(pools):
            x = torch.relu(torch.randn(n, ph, pw, pc, device=DEVICE, generator=g)).to(dtype)
            sync()
            kernels.reset_launches()
            y_k = kernels.max_pool2d(x, pk, ps, pp)
            xi = x.clone().requires_grad_()
            out_k = kernels.pool2d_train(xi, "max", pk, ps, pp)
            cot = (torch.randint(-64, 65, out_k.shape, device=DEVICE, generator=g) / 16).to(dtype)
            dx_k, = torch.autograd.grad(out_k, xi, cot)
            sync()
            launched = dict(kernels.LAUNCHES)
            routes = {k2: dict(kernels.ROUTE_LAUNCHES[k2])
                      for k2 in ("max_pool2d", "pool2d_backward")}
            route = "vector" if pc % 8 == 0 else "loop"
            other = "loop" if route == "vector" else "vector"
            y_p = kernels.max_pool2d_plain(x, pk, ps, pp)
            with plain_kernels():
                xi = x.clone().requires_grad_()
                out_p = kernels.pool2d_train(xi, "max", pk, ps, pp)
                dx_p, = torch.autograd.grad(out_p, xi, cot)
            sync()
            err_y = float((y_k.float() - y_p.float()).abs().max())
            err_t = float((out_k.detach().float() - out_p.detach().float()).abs().max())
            err_dx = float((dx_k.float() - dx_p.float()).abs().max())
            ok = (max(err_y, err_t, err_dx) <= POOL_TOL and launched["max_pool2d"] == 2
                  and launched["pool2d_backward"] == 1
                  and routes == {"max_pool2d": {route: 2, other: 0},
                                 "pool2d_backward": {route: 1, other: 0}})
            say(f"  max pool {n} {ph} {pw} {pc} {pk} {ps} {pp} | {dname} | max_pool2d y "
                f"{err_y:.3e}, pool2d_train y {err_t:.3e} dx {err_dx:.3e} (exact), routes "
                f"{routes} {'ok' if ok else 'FAIL'}")
            if not ok:
                bad += 1
                failures.append(f"{label} pool {ph}x{pw}x{pc} k{pk} s{ps} p{pp} {dname}: y "
                                f"{err_y:.3e} train {err_t:.3e} dx {err_dx:.3e}, routes {routes}")
            rows["max_pool2d"]["err"] = max(rows["max_pool2d"]["err"], err_y)
            rows["pool2d_train"]["err"] = max(rows["pool2d_train"]["err"], err_t, err_dx)
            rows["pool2d_backward"]["err"] = max(rows["pool2d_backward"]["err"], err_dx)
            del x, xi, out_k, out_p, dx_k, dx_p
    say(f"{label} layer check: {len(distinct)} distinct conv shapes ({uses} convs) and "
        f"{len(pools)} max-pool shapes, at "
        f"{', '.join(f'b{n} {dname_of(d)}' for n, d in runs)}: {'ok' if not bad else 'FAIL'}")
    return len(distinct), uses


def trainer_fp32_check(seed, out_dir, failures):
    """(iv) one fp32 epoch on a 1,024-image subset at batch 64, dropout 0,
    at TRAINER_FP32_LR: the kernel path, the plain path, the plain path with
    perturbed conv weights (the control, which sets the bar) and the plain
    path in bf16 (a lower-precision reading, printed beside). Compared: the
    epoch's train and valid loss. Returns the readings."""
    import torch

    from convnets_tpu_torch.data import ArrayDataset, DataLoader
    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.train import Trainer

    train, valid = trainer_data(seed)
    sub = [ArrayDataset(ds.images[:n], ds.labels[:n])
           for ds, n in ((train, SUBSET_TRAIN), (valid, SUBSET_VALID))]
    losses = {}
    for path in ("kernel", "plain", "control", "bf16"):
        setting = trainer_setting(seed, os.path.join(out_dir, f"fp32-{path}"), epochs=1,
                                  batch_size=SUBSET_BATCH, mixed_precision=path == "bf16",
                                  dropout_rate=0.0, learning_rate=TRAINER_FP32_LR)
        model = build_model("resnet", setting, device=DEVICE)
        if path == "control":
            gen = torch.Generator(device=DEVICE).manual_seed(seed)
            with torch.no_grad():
                for p in model.parameters():
                    if p.ndim == 4:
                        p.mul_(1 + TRAINER_CONTROL_PERTURBATION * torch.randn(
                            p.shape, device=DEVICE, generator=gen))
        trainer = Trainer(model)
        with plain_kernels() if path != "kernel" else contextlib.nullcontext():
            trainer.fit(DataLoader(sub[0], SUBSET_BATCH, shuffle=True, seed=seed),
                        DataLoader(sub[1], SUBSET_BATCH))
        trainer.close()
        r = trainer.epoch_results
        losses[path] = np.array([r["train_loss"][0], r["valid_loss"][0]])
    rel = {k: float(np.max(np.abs(losses[k] - losses["plain"]) / np.abs(losses["plain"])))
           for k in ("kernel", "control", "bf16")}
    bar = min(TRAINER_MAX_BAR, CONTROL_FACTOR * rel["control"])
    ok = rel["kernel"] <= bar and bool(np.isfinite(losses["kernel"]).all())
    say(f"(iv) fp32 RN26@32 epoch ({SUBSET_TRAIN} images, batch {SUBSET_BATCH}, lr "
        f"{TRAINER_FP32_LR:g}, dropout 0), (train loss, valid loss): kernel "
        f"{losses['kernel'].tolist()}, plain {losses['plain'].tolist()}, control "
        f"{losses['control'].tolist()}, plain in bf16 {losses['bf16'].tolist()}; kernel vs plain "
        f"rel {rel['kernel']:.3e}, bar {bar:.3e} = min({TRAINER_MAX_BAR:g}, {CONTROL_FACTOR:g} x "
        f"control {rel['control']:.3e}; conv weights x(1 + {TRAINER_CONTROL_PERTURBATION:g}"
        f"·N(0,1))) {'ok' if ok else 'FAIL'}; bf16 vs plain rel {rel['bf16']:.3e} (a reading: "
        f"the step check above holds the gradients)")
    if not ok:
        failures.append(f"fp32 RN26@32 epoch: kernel vs plain {rel['kernel']:.3e} > bar {bar:.3e}")
    return {"kernel_vs_plain_rel": rel["kernel"], "control_rel": rel["control"], "bar": bar,
            "bf16_vs_plain_rel": rel["bf16"]}


def step_loop_rate(seed):
    """train_throughput's protocol on RN26@32 at b256: WARMUP and TIMED
    steps on one uint8 batch already on the card, fenced."""
    import torch

    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.train import build_train_step, create_train_state

    model = build_model("resnet", trainer_setting(seed, ""), device=DEVICE)
    state = create_train_state(model)
    step = build_train_step(state, norm=True)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randint(0, 256, (TRAINER_BATCH, 32, 32, 3), dtype=torch.uint8, device=DEVICE,
                      generator=gen)
    y = torch.randint(0, 10, (TRAINER_BATCH,), device=DEVICE, generator=gen)
    return TRAINER_BATCH / timed_steps(step, state, x, y, gen)[0]


def phase_trainer(seed, card, summary, failures):
    """Phase 10: the Trainer on RN26@32, bf16: (i) fit 2 epochs, then the
    path's kernels at its shapes against their plain versions, (ii) a fresh
    Trainer resumes from the checkpoint for 1 more, (iii) evaluate, test
    and reestimate_bn, (iv) one fp32 step and one fp32 epoch, kernel vs plain, (v) epoch
    img/s against the step loop's, and the idle share of one profiled
    epoch. Prints the trainer JSON line; returns the launches of (i)'s fit,
    the path's own run, and the per-call launches of its train steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from convnets_tpu_torch import bridge
    from convnets_tpu_torch.data import DataLoader
    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.train import Trainer
    from convnets_tpu_torch.train import checkpoint as ckpt

    parts = {}
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        train_ds, valid_ds = trainer_data(seed)
        parts["data"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        setting = trainer_setting(seed, out_dir)

        # (i) fit
        trainer = Trainer(build_model("resnet", setting, device=DEVICE))
        n = conv_count(trainer.model)
        train = DataLoader(train_ds, TRAINER_BATCH, shuffle=True, seed=seed, num_workers=2)
        valid = DataLoader(valid_ds, TRAINER_BATCH)
        calls, batches, epoch_s = {"train": [], "eval": []}, [], []
        count_calls(trainer, calls)
        timed_train_epochs(trainer, epoch_s)
        sync()
        kernels.reset_launches()
        with recorded_batches(batches):
            trainer.fit(train, valid)
        sync()
        fit_launches = dict(kernels.LAUNCHES)
        check_routes("RN26@32 fit", fit_launches, failures)
        trainer.close()
        first = dict(trainer.epoch_results)
        per_step = launches_of({"conv2d_stats": n, "conv2d_stats_reduce": n, "max_pool2d": 1,
                                "pool2d_backward": 1, **bn_sites(n)})
        per_eval = launches_of({"conv2d_fused": n, "max_pool2d": 1})
        steps, evals = len(train) * TRAINER_EPOCHS, len(valid) * TRAINER_EPOCHS
        full = TRAINER_BATCH * 32 * 32 * 3
        ok_calls = (len(calls["train"]) == steps and len(calls["eval"]) == evals
                    and all(c == per_step for c in calls["train"])
                    and all(c == per_eval for c in calls["eval"]))
        ok_bytes = (len(batches) == steps + evals
                    and all(b == (torch.uint8, full, "cuda") for b in batches))
        last = ckpt.get_last_checkpoint(out_dir, trainer.model.model_name)
        ok_ckpt = os.path.exists(trainer.model_path) and last == trainer.model_path
        say(f"(i) fit RN26@32 bf16, {TRAINER_TRAIN} train / {TRAINER_VALID} valid images, batch "
            f"{TRAINER_BATCH}, {TRAINER_EPOCHS} epochs: train loss {first['train_loss']}, "
            f"valid acc {first['valid_score']}, lr {first['learning_rate']}, best epoch "
            f"{first['train_epochs']}; checkpoint {os.path.basename(last or '')} "
            f"{'ok' if ok_ckpt else 'FAIL'}")
        say(f"    launches: {len(calls['train'])} train steps each "
            f"{ {k: v for k, v in per_step.items() if v} } ({n} convs), {len(calls['eval'])} "
            f"eval batches each { {k: v for k, v in per_eval.items() if v} }: "
            f"{'ok' if ok_calls else 'FAIL'}; batches on the card: {len(batches)}, each "
            f"{sorted(set(batches), key=str)} (a full uint8 batch is {full} B) "
            f"{'ok' if ok_bytes else 'FAIL'}")
        if not ok_calls:
            bad = [c for c in calls["train"] if c != per_step][:1] + \
                  [c for c in calls["eval"] if c != per_eval][:1]
            failures.append(f"RN26@32 fit launches per call off: {bad}")
        if not ok_bytes:
            failures.append(f"RN26@32 fit batches: {sorted(set(batches), key=str)}")
        if not ok_ckpt:
            failures.append(f"RN26@32 fit: checkpoint {trainer.model_path} / {last}")

        parts["i"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        distinct, covered = layer_check("RN26@32", [trainer.model],
                                        ((TRAINER_BATCH, torch.bfloat16),
                                         (SUBSET_BATCH, torch.float32)), summary, failures)
        parts["i_layers"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        # (ii) resume in a fresh Trainer over a fresh model
        resumed = Trainer(build_model("resnet", trainer_setting(seed + 1, out_dir),
                                      device=DEVICE))
        best = resumed.load_checkpoint()["epoch_results"]["train_epochs"]
        trees, _ = ckpt.load_checkpoint(trainer.model_path)
        files = bridge._flatten({"params": trees["params"], "state": trees["model_state"]})
        ok_load = all(torch.equal(getattr(mod, t).detach().float(),
                                  torch.from_numpy(files[path]).to(DEVICE))
                      for path, (mod, t) in bridge.jax_layout(resumed.model).items())
        resumed.setting.epochs = 1
        timed_train_epochs(resumed, epoch_s)
        resumed.fit(train, valid, resume=True)
        resumed.close()
        r = resumed.epoch_results
        total = best + 1  # the history is cut back to the best epoch, then one more
        lrs = [0.05 * 0.1 ** (e // 2) for e in range(total)]
        ok_resume = (ok_load and r["total_epochs"] == total
                     and np.allclose(r["learning_rate"], lrs, rtol=1e-6, atol=0)
                     and r["train_loss"][-1] < r["train_loss"][0]
                     and r["valid_score"][-1] > TRAINER_MIN_ACC)
        say(f"(ii) resume: params and BN buffers equal to the file's: {ok_load}; total epochs "
            f"{r['total_epochs']} (expected {total}), lr {r['learning_rate']} (step schedule "
            f"{lrs}), train loss {r['train_loss']}, valid acc {r['valid_score']} (> "
            f"{TRAINER_MIN_ACC}) {'ok' if ok_resume else 'FAIL'}")
        if not ok_resume:
            failures.append(f"RN26@32 resume: load {ok_load}, epochs {r['total_epochs']}/{total}, "
                            f"lr {r['learning_rate']}, loss {r['train_loss']}, "
                            f"acc {r['valid_score']}")

        parts["ii"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        # (iii) evaluate and test
        acc = resumed.evaluate(valid, info=False)
        cm_sum = int(resumed.confusion_matrix.sum())
        _, times, fps = resumed.test(valid)
        _, per_image, per_image_std, _ = resumed.inference_time(
            times, TRAINER_VALID, info=False, full_batches=np.ones(len(times), bool))
        trace = int(np.trace(resumed.confusion_matrix))
        ok_eval = (cm_sum == TRAINER_VALID and abs(acc - trace / cm_sum) < 1e-12
                   and acc > TRAINER_MIN_ACC)
        say(f"(iii) evaluate: accuracy {acc:.4f} (> {TRAINER_MIN_ACC}), confusion matrix sum "
            f"{cm_sum} (expected {TRAINER_VALID}), trace {trace} "
            f"{'ok' if ok_eval else 'FAIL'}; test: {fps:.1f} img/s, "
            f"{1e3 * per_image:.4f} ± {1e3 * per_image_std:.4f} ms per image at batch "
            f"{TRAINER_BATCH}")
        if not ok_eval:
            failures.append(f"RN26@32 evaluate: acc {acc}, cm sum {cm_sum}, trace {trace}")

        # (iii) reestimate_bn over the valid loader: train-mode forwards of
        # full batches under no_grad move the BN running statistics alone
        params = {k: p.detach().clone() for k, p in resumed.model.named_parameters()}
        running = {k: b.clone() for k, b in resumed.model.named_buffers()
                   if b.is_floating_point()}
        full_batches = TRAINER_VALID // TRAINER_BATCH
        sync()
        kernels.reset_launches()
        resumed.reestimate_bn(valid, passes=1, info=False)
        sync()
        re_launches = dict(kernels.LAUNCHES)
        check_routes("RN26@32 reestimate_bn", re_launches, failures)
        want_re = launches_of({k: v * full_batches for k, v in per_step.items()
                               if k not in ("pool2d_backward", *BN_ACT_BACKWARD)})
        moved = sum(not torch.equal(b, running[k]) for k, b in resumed.model.named_buffers()
                    if k in running)
        same = all(torch.equal(p, params[k]) for k, p in resumed.model.named_parameters())
        acc_re = resumed.evaluate(valid, info=False)
        ok_re = (re_launches == want_re and same and moved == len(running)
                 and not resumed.model.training and acc_re > TRAINER_MIN_ACC)
        say(f"(iii) reestimate_bn over {full_batches} full batches: launches "
            f"{ {k: v for k, v in re_launches.items() if v} } (expected "
            f"{ {k: v for k, v in want_re.items() if v} }), params unchanged {same}, running "
            f"statistics moved {moved} of {len(running)}, eval mode after it "
            f"{not resumed.model.training}, accuracy then {acc_re:.4f} "
            f"{'ok' if ok_re else 'FAIL'}")
        if not ok_re:
            failures.append(f"RN26@32 reestimate_bn: launches {re_launches}, params same {same}, "
                            f"moved {moved}/{len(running)}, acc {acc_re}")

        # (v) one train epoch under the profiler, device activity only (the
        # host's ~4,000 ops per step would take longer to trace than the
        # epoch runs): device time against the host clock, and each
        # host-to-device copy's bytes
        parts["iii"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            Trainer._run_train_epoch(resumed, train, 99)  # not the timed wrapper
            host = time.perf_counter() - t1
        device, ours, _ = device_split(prof, OUR_KERNELS)
        # the profiler can miss a few memcpy records (it recorded 30 of 32
        # in one run): every batch's bytes are held exactly in (i); here
        # every image copy it did record must be one uint8 batch
        copies = h2d_copies(prof)
        x_copies = [b for b, _ in copies if b >= full]
        idle = 1.0 - device / 1e6 / host
        ok_copies = (set(x_copies) == {full} and 2 * len(x_copies) >= len(train)
                     and device > 0)
        say(f"(v) profiled epoch ({len(train)} steps): device {device / 1e3:.3f} ms of "
            f"{1e3 * host:.3f} ms host clock, idle share {idle:.4f}; the port's kernels "
            f"{ours / 1e3:.3f} ms; image copies recorded {len(x_copies)} (of {len(train)} "
            f"batches), each of {sorted(set(x_copies))} B {'ok' if ok_copies else 'FAIL'}")
        if not ok_copies:
            failures.append(f"RN26@32 profiled epoch: device {device} us, image copies "
                            f"{x_copies[:4]}")
        parts["v_profile"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        # (iv) one fp32 step (per-leaf gradients) and one fp32 epoch, kernel
        # vs plain; (v) the step loop
        one_step = step_check("resnet26@32", seed, failures, batch=SUBSET_BATCH, image=32,
                              classes=10, low_control=True,
                              make=lambda **kw: build_model(
                                  "resnet", trainer_setting(seed, "", **kw), device=DEVICE))
        fp32 = trainer_fp32_check(seed, out_dir, failures)
        parts["iv"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loop_rate = step_loop_rate(seed)
    parts["v_step_loop"] = time.perf_counter() - t0
    epoch_rates = [TRAINER_TRAIN / t for t in epoch_s]
    say(f"(v) train img/s per epoch (fit's host clock, fenced): "
        f"{[round(v, 1) for v in epoch_rates]}; step loop on one batch on the card "
        f"{loop_rate:.1f} img/s; seconds per part {parts}")
    say(json.dumps({"trainer": {
        "card": card, "model": "resnet26", "input": [3, 32, 32], "dtype": "bfloat16",
        "batch": TRAINER_BATCH, "train_images": TRAINER_TRAIN, "valid_images": TRAINER_VALID,
        "convs": n, "launches_per_train_step": {k: v for k, v in per_step.items() if v},
        "launches_per_eval_batch": {k: v for k, v in per_eval.items() if v},
        "fit_launches": {k: v for k, v in fit_launches.items() if v},
        "batch_bytes": sorted({b for _, b, _ in batches}),
        "train_loss": r["train_loss"], "valid_loss": r["valid_loss"],
        "valid_score": r["valid_score"], "learning_rate": r["learning_rate"],
        "total_epochs": r["total_epochs"], "evaluate_accuracy": acc,
        "test_img_s": fps, "test_ms_per_image": 1e3 * per_image,
        "epoch_img_s": epoch_rates, "step_loop_img_s": loop_rate,
        "profiled_epoch": {"host_ms": 1e3 * host, "device_ms": device / 1e3,
                           "idle_share": idle, "kernels_ms": ours / 1e3},
        "layers_checked": {"distinct_conv_shapes": distinct, "convs": covered,
                           "batches_dtypes": [[TRAINER_BATCH, "bfloat16"],
                                              [SUBSET_BATCH, "float32"]]},
        "fp32_step": one_step, "fp32_epoch": fp32,
        "seconds": parts}}))
    return fit_launches, calls["train"]


# phase 11: the single-file artifact and the device data path
ARTIFACT_BATCHES = (1, 64, 256)  # (i): served from one RN50 artifact
ARTIFACT_FP32_BATCHES = (1, 8)  # (i): the fp32 artifact against the live fp32 model
ARTIFACT_FP32_TOL = 1e-6  # (i): fp32 |Δ logit| ≤ tol · max |logit|
AUG_EPOCHS, AUG_CUTOUT, AUG_MIXUP = 3, 8, 0.2  # (iii)
# (v): the augmentation on the card against the same function on the CPU,
# fp32, max |Δ|: the separable resample's sums run in another order
AUG_TOL = 1e-5
AUG_CHECK_BATCH = 16  # (v)'s RandomResizedCrop / center crop check, 256² → 224²
RRC_RAW = 256  # (v): the RN50@224 b256 step's uint8 images are 256²
DISPATCH_CALLS = 200  # (i): host µs per call, op against wrapper
# (ii): a fresh process loads the artifact and serves one request; argv:
# repository root, artifact path, seed, image side
CHILD = """
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import torch
from convnets_tpu_torch.ops import kernels
from convnets_tpu_torch.serve import load_artifact
served = load_artifact(sys.argv[2])
side = int(sys.argv[4])
x = np.random.default_rng(int(sys.argv[3])).integers(0, 256, (8, side, side, 3), dtype=np.uint8)
served(x[:1])
torch.cuda.synchronize()
kernels.reset_launches()
y = served(x)
torch.cuda.synchronize()
print(json.dumps({"launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
                  "shape": list(y.shape), "finite": bool(torch.isfinite(y).all()),
                  "argmax": y.argmax(-1).tolist(), "logits": y.float().cpu().tolist(),
                  "models_imported": "convnets_tpu_torch.models" in sys.modules,
                  "jax_imported": any(m == "jax" or m.startswith("jax.") for m in sys.modules)}))
"""


def seconds_per_request(server, req, iters=10):
    """Host seconds per request (uint8 from the host, logits on the card),
    fenced by synchronize, after two warm-up requests."""
    for _ in range(2):
        server(req)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        server(req)
    sync()
    return (time.perf_counter() - t0) / iters


def dispatch_us(seed):
    """Host µs per call of the conv2d_fused op against its wrapper, at
    RN50's last 1x1 conv at batch 1 (7²×2048 → 512, a kernel far shorter
    than either call), in turns, DISPATCH_CALLS calls each, fenced: the
    op under inference_mode (as ServingModel calls it) and with grad mode
    on (the custom op's autograd wrapper runs)."""
    import torch

    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.ops.kernels import library

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(1, 7, 7, 2048, device=DEVICE, generator=g).bfloat16()
    w = (torch.randn(1, 1, 2048, 512, device=DEVICE, generator=g) / 45).bfloat16()
    s, b = torch.ones(512, device=DEVICE), torch.zeros(512, device=DEVICE)
    op = getattr(torch.ops, library.NAMESPACE).conv2d_fused
    calls = {"wrapper": lambda: kernels.conv2d_fused(x, w, s, b, stride=(1, 1), padding=(0, 0),
                                                     relu=True),
             "op": lambda: op(x, w, s, b, [1, 1], [0, 0], True)}
    runs = {"wrapper": [], "op": [], "op_grad_mode": []}
    for name in ("wrapper", "op", "op_grad_mode", "op_grad_mode", "op", "wrapper"):
        fn = calls[name[:2] if name.startswith("op") else name]
        with torch.inference_mode() if name != "op_grad_mode" else contextlib.nullcontext():
            fn()
            sync()
            t0 = time.perf_counter()
            for _ in range(DISPATCH_CALLS):
                fn()
            sync()
        runs[name].append(1e6 * (time.perf_counter() - t0) / DISPATCH_CALLS)
    return {k: float(np.mean(v)) for k, v in runs.items()}, runs


def artifact_check(seed, out_dir, failures):
    """(i) RN50@224 exported as a bf16 and an fp32 artifact (uint8 wire,
    baked normalization, symbolic batch); the bf16 one serves batches 1, 64
    and 256 from one file, each request's launches and plans read; logits
    against the live ServingModel; img/s in turns; the H2D bytes of a b64
    request; the op's dispatch cost. (ii) a fresh process serves from it.
    Returns (results, the launches of the artifact's requests)."""
    from collections import Counter

    import torch
    from torch.profiler import ProfilerActivity, profile

    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.ops.kernels import conv as conv_kernels
    from convnets_tpu_torch.serve import ServingModel, load_artifact, save_artifact

    res = {}
    models = {"bf16": make_model("resnet", seed, True), "fp32": make_model("resnet", seed, False)}
    paths = {k: os.path.join(out_dir, f"rn50_{k}.bin") for k in models}
    for k, model in models.items():
        t0 = time.perf_counter()
        meta = save_artifact(paths[k], model, input_dtype="uint8", stats=IMAGENET_STATS)
        res[f"export_{k}_s"] = time.perf_counter() - t0
        res[f"artifact_{k}_mb"] = os.path.getsize(paths[k]) / 2 ** 20
    t0 = time.perf_counter()
    served = load_artifact(paths["bf16"])
    res["load_s"] = time.perf_counter() - t0
    live = ServingModel(models["bf16"], input_dtype="uint8", stats=IMAGENET_STATS)
    ok_meta = (served.meta["batch"] == "symbolic" and served.meta["platforms"] == ["cuda"]
               and served.meta["input_contract"]["normalization_baked"]
               and served.device.type == "cuda")
    rng = np.random.default_rng(seed + 11)
    reqs = {b: rng.integers(0, 256, (b, IMAGE, IMAGE, 3), dtype=np.uint8)
            for b in ARTIFACT_BATCHES}
    served(reqs[1])
    sync()

    # one request per batch from the one artifact: its launches and the
    # conv_plan tile each of its convs ran
    plans, launched, outs, seen = {}, {}, {}, []
    plan_fn = conv_kernels.conv_plan

    def recording(*args, **kw):
        seen.append(plan_fn(*args, **kw))
        return seen[-1]

    conv_kernels.conv_plan = recording
    try:
        for b in ARTIFACT_BATCHES:
            seen.clear()
            sync()
            kernels.reset_launches()
            outs[b] = served(reqs[b])
            sync()
            launched[b] = dict(kernels.LAUNCHES)
            check_routes(f"RN50 artifact b{b}", launched[b], failures)
            plans[b] = Counter(f"{p.bm}x{p.bn} {p.gather}" for p in seen)
    finally:
        conv_kernels.conv_plan = plan_fn
    want = launches_of(SERVE_LAUNCHES["resnet"])
    ok_launch = all(v == want for v in launched.values())
    ok_plans = set(plans[1]) != set(plans[ARTIFACT_BATCHES[-1]])
    for b in ARTIFACT_BATCHES:
        say(f"(i) RN50 bf16 artifact, request b{b}: logits {tuple(outs[b].shape)}, launches "
            f"{ {k: v for k, v in launched[b].items() if v} }, conv_plan tiles "
            f"{dict(plans[b])}")
    say(f"(i) launches per request exactly {SERVE_LAUNCHES['resnet']}: "
        f"{'ok' if ok_launch else 'FAIL'}; b1 and b{ARTIFACT_BATCHES[-1]} ran different "
        f"tiles: {'ok' if ok_plans else 'FAIL'}; metadata {'ok' if ok_meta else 'FAIL'}")
    if not (ok_launch and ok_plans and ok_meta):
        failures.append(f"RN50 artifact: launches {launched}, plans {plans}, meta {served.meta}")
    res["launches_per_request"] = {k: v for k, v in want.items() if v}
    res["plans"] = {str(b): dict(p) for b, p in plans.items()}

    # logits against the live ServingModel: bf16 argmax, fp32 within a bar
    refs = {b: live(reqs[b]) for b in ARTIFACT_BATCHES}
    sync()
    agree = float(torch.cat([(outs[b].argmax(-1) == refs[b].argmax(-1)).double()
                             for b in ARTIFACT_BATCHES]).mean())
    bf16_same = all(torch.equal(outs[b], refs[b]) for b in ARTIFACT_BATCHES)
    served32 = load_artifact(paths["fp32"])
    live32 = ServingModel(models["fp32"], input_dtype="uint8", stats=IMAGENET_STATS)
    rel32, fp32_same = 0.0, True
    for b in ARTIFACT_FP32_BATCHES:
        a, r = served32(reqs[ARTIFACT_BATCHES[-1]][:b]), live32(reqs[ARTIFACT_BATCHES[-1]][:b])
        rel32 = max(rel32, float((a - r).abs().max() / r.abs().max()))
        fp32_same = fp32_same and torch.equal(a, r)
    ok_logits = agree >= ARGMAX_MIN and rel32 <= ARTIFACT_FP32_TOL
    say(f"(i) artifact vs live ServingModel: bf16 argmax agreement {agree:.4f} over "
        f"{sum(ARTIFACT_BATCHES)} images (min {ARGMAX_MIN}), bit-identical {bf16_same}; fp32 "
        f"(b{ARTIFACT_FP32_BATCHES}) max |Δ| / max |logit| {rel32:.3e} (tol "
        f"{ARTIFACT_FP32_TOL:g}), bit-identical {fp32_same} {'ok' if ok_logits else 'FAIL'}")
    if not ok_logits:
        failures.append(f"RN50 artifact logits: bf16 agreement {agree}, fp32 rel {rel32}")
    res.update(bf16_argmax_agreement=agree, bf16_bit_identical=bf16_same, fp32_rel=rel32,
               fp32_bit_identical=fp32_same)
    del served32, live32

    # the H2D bytes of three b64 requests (the profiler can drop a memcpy
    # record: each recorded copy must be one uint8 request)
    b = ARTIFACT_BATCHES[1]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            served(reqs[b])
        sync()
    copies = [nbytes for nbytes, _ in h2d_copies(prof)]
    ok_h2d = 1 <= len(copies) <= 3 and set(copies) == {reqs[b].nbytes}
    say(f"(i) artifact b{b}, 3 requests: host-to-device copies recorded {copies} B (the uint8 "
        f"request is {reqs[b].nbytes} B) {'ok' if ok_h2d else 'FAIL'}")
    if not ok_h2d:
        failures.append(f"RN50 artifact b{b} H2D copies {copies}")
    res[f"h2d_bytes_b{b}"] = copies

    # img/s, artifact against the live model, in turns
    for b in ARTIFACT_BATCHES[1:]:
        runs = {"live": [], "artifact": []}
        for name in ("live", "artifact", "artifact", "live"):
            runs[name].append(seconds_per_request(served if name == "artifact" else live, reqs[b]))
        rates = {k: b / float(np.mean(v)) for k, v in runs.items()}
        say(f"(i) serving RN50@224 bf16 b{b}, uint8 from the host: artifact "
            f"{rates['artifact']:.1f} img/s, live ServingModel {rates['live']:.1f} img/s (ms per "
            f"request in turns: { {k: [round(1e3 * t, 3) for t in v] for k, v in runs.items()} })")
        res[f"img_s_b{b}"] = rates
    mean_us, runs = dispatch_us(seed)
    say(f"(i) dispatch: host µs per call at RN50's 7²×2048→512 1x1 conv, b1 bf16: wrapper "
        f"{mean_us['wrapper']:.2f}, op under inference_mode {mean_us['op']:.2f} "
        f"(+{mean_us['op'] - mean_us['wrapper']:.2f}), op in grad mode "
        f"{mean_us['op_grad_mode']:.2f}; runs {runs}")
    res["dispatch_us"] = mean_us

    # (ii) a fresh process: the op library, no model code
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CHILD, HERE, paths["bf16"], str(seed), str(IMAGE)],
                          capture_output=True, text=True, timeout=600)
    child = json.loads(proc.stdout.strip().splitlines()[-1]) if proc.returncode == 0 else {}
    x8 = np.random.default_rng(seed).integers(0, 256, (8, IMAGE, IMAGE, 3), dtype=np.uint8)
    mine = served(x8).argmax(-1).tolist()
    ok_child = (proc.returncode == 0 and child["launches"] == SERVE_LAUNCHES["resnet"]
                and child["shape"] == [8, 1000] and child["finite"]
                and not child["models_imported"] and not child["jax_imported"]
                and child["argmax"] == mine)
    say(f"(ii) fresh process (rc {proc.returncode}, {time.perf_counter() - t0:.1f} s): "
        f"{ {k: v for k, v in child.items() if k != 'argmax'} }, argmax equal to this "
        f"process's {child.get('argmax') == mine} {'ok' if ok_child else 'FAIL'}")
    if not ok_child:
        failures.append(f"fresh-process artifact: rc {proc.returncode} {child} "
                        f"{proc.stderr[-2000:]}")
    res["fresh_process"] = {k: v for k, v in child.items() if k != "argmax"}
    del served, live, models
    return res, launched[ARTIFACT_BATCHES[-1]]


def cross_device_check(seed, out_dir, failures):
    """(i) an artifact exported on the CPU (RN26@32, fp32) loaded on the
    card: move_to_device_pass moves its constants; its logits against the
    same model exported on the card."""
    import torch

    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.serve import load_artifact, save_artifact

    setting = trainer_setting(seed, "", mixed_precision=False)
    cpu_model = build_model("resnet", setting, device="cpu")
    card_model = build_model("resnet", setting, device=DEVICE)
    card_model.load_state_dict(cpu_model.state_dict())
    paths = [os.path.join(out_dir, f"rn26_{d}.bin") for d in ("cpu", "cuda")]
    save_artifact(paths[0], cpu_model, input_dtype="uint8", stats=IMAGENET_STATS)
    save_artifact(paths[1], card_model, input_dtype="uint8", stats=IMAGENET_STATS)
    moved, native = (load_artifact(p) for p in paths)
    x = np.random.default_rng(seed).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    a, b = moved(x), native(x)
    sync()
    rel = float((a - b).abs().max() / b.abs().max())
    ok = a.device.type == "cuda" and rel <= ARTIFACT_FP32_TOL
    say(f"(i) RN26@32 fp32 artifact exported on the CPU, served on the card: max |Δ| / max "
        f"|logit| against the card's own export {rel:.3e} (tol {ARTIFACT_FP32_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"cross-device artifact: {a.device}, rel {rel}")
    return rel


def aug_card_check(seed, failures):
    """(v) each augmentation function on the card against the same function
    on the CPU, with parameters drawn once on the CPU: crop + flip + affine
    (the gather) and crop + flip (separable) at RN26@32 b256, cutout,
    mixup, normalize, and RandomResizedCrop and the center crop 256² →
    224²; fp32, max |Δ| ≤ AUG_TOL."""
    import torch

    from convnets_tpu_torch.data import augment as A

    g = torch.Generator().manual_seed(seed)
    x = torch.rand(TRAINER_BATCH, 32, 32, 3, generator=g)
    big = torch.rand(AUG_CHECK_BATCH, RRC_RAW, RRC_RAW, 3, generator=g)
    m = A.affine_matrices(A.affine_draws(g, TRAINER_BATCH))
    cut = A.cutout_draws(g, TRAINER_BATCH, 32, 32)
    rrc = A.resized_crop_draws(g, AUG_CHECK_BATCH)
    mix = A.MixupDraws(0.3, torch.randperm(TRAINER_BATCH, generator=g))

    def card(t):
        return t.to(DEVICE) if isinstance(t, torch.Tensor) else t

    def both(fn, *args):
        ref = fn(*args)
        got = fn(*(type(a)(*map(card, a)) if isinstance(a, tuple) else card(a) for a in args))
        sync()
        return float((got.cpu() - ref).abs().max())

    errs = {"augment_batch (affine, gather)": both(lambda a, b: A.augment_apply(a, b, True), x, m),
            "augment_batch (crop + flip, separable)": both(
                lambda a, b: A.augment_apply(a, b, False), x, m),
            "cutout": both(lambda a, b: A.cutout_apply(a, b, AUG_CUTOUT), x, cut),
            "mixup": both(A.mixup_apply, x, mix),
            "normalize": both(lambda a: A.normalize(a, *IMAGENET_STATS), x),
            "random_resized_crop_batch": both(
                lambda a, b: A.resized_crop_apply(a, (IMAGE, IMAGE), b), big, rrc),
            "center_crop_resize": both(lambda a: A.center_crop_resize(a, (IMAGE, IMAGE)), big)}
    ok = max(errs.values()) <= AUG_TOL
    say(f"(v) augmentation on the card vs the CPU, same parameters, fp32 max |Δ| (tol "
        f"{AUG_TOL:g}): { {k: f'{v:.2e}' for k, v in errs.items()} } {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"augmentation card vs CPU: {errs}")
    return errs


def rrc_step_check(seed, failures):
    """(v) one RN50@224 b256 bf16 train step whose uint8 batch is 256²:
    RandomResizedCrop to 224² runs on the card inside it; the step's ms
    against the preprocessing's (device time)."""
    import torch

    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.train import build_train_step, create_train_state
    from convnets_tpu_torch.train.engine import _make_preprocess, data_rng

    batch = TRAIN_BATCH["resnet"]
    model = make_model("resnet", seed, True)
    state = create_train_state(model)
    step = build_train_step(state, augment=True, norm=True, stats=IMAGENET_STATS)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randint(0, 256, (batch, RRC_RAW, RRC_RAW, 3), dtype=torch.uint8, device=DEVICE,
                      generator=gen)
    y = torch.randint(0, 1000, (batch,), device=DEVICE, generator=gen)
    rng = data_rng(seed, DEVICE, 0, 0)
    loss, _ = step(state, x, y, None, gen, rng)
    sync()
    kernels.reset_launches()
    step_ms = time_ms(lambda: step(state, x, y, None, gen, rng), 3)
    sync()
    calls = 3 + 2  # time_ms's warm-up and host-timing calls, then the timed ones
    per_step = {k: v / calls for k, v in kernels.LAUNCHES.items()}
    pre = _make_preprocess(model, True, IMAGENET_STATS, augment=True)
    pre_ms = time_ms(lambda: pre(x, rng), 3)
    ok = bool(torch.isfinite(loss)) and per_step == launches_of(TRAIN_LAUNCHES["resnet"])
    say(f"(v) RN50@224 b{batch} bf16 train step on {RRC_RAW}² uint8 images (RandomResizedCrop "
        f"on the card): {step_ms:.2f} ms per step, of it the preprocessing (dequantize, crop + "
        f"resize, normalize) {pre_ms:.2f} ms ({100 * pre_ms / step_ms:.2f}%); launches per "
        f"step { {k: v for k, v in per_step.items() if v} } {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"RN50 256² augmented step: loss {float(loss)}, launches {per_step}")
    return {"step_ms": step_ms, "preprocess_ms": pre_ms}


def aug_fit_check(seed, out_dir, failures):
    """(iii) RN26@32 fit with the JAX defaults (data_augment, affine,
    data_norm) plus cutout and mixup, on phase 10's data through DataMngr's
    route to DeviceCacheLoader, AUG_EPOCHS epochs: per-call launches, the
    split's one-time copy, learning; (iv) the fitted model exported,
    served from its artifact against Trainer.test's predictions; (iii) one
    profiled epoch (H2D copies per step, idle share) and the
    augmentation's share of a step. Returns (results, fit launches, the
    per-call train launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from convnets_tpu_torch.data import DataMngr, DeviceCacheLoader
    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.serve import export_trainer, load_artifact
    from convnets_tpu_torch.train import Trainer
    from convnets_tpu_torch.train.engine import _make_preprocess, data_rng

    res = {}
    train_ds, valid_ds = trainer_data(seed)
    setting = trainer_setting(seed, out_dir, epochs=AUG_EPOCHS, data_augment=True,
                              augment_affine=True, data_norm=True, cutout=AUG_CUTOUT,
                              mixup=AUG_MIXUP)
    mngr = DataMngr(setting, device=DEVICE, datasets={"train": train_ds, "valid": valid_ds})
    train, valid = mngr.load_train(), mngr.load_valid()
    # the one-time copy: each split's images and labels as they lie on the
    # card (the profiled epoch below shows that no image crosses again)
    resident = [(str(t.dtype), t.numel() * t.element_size(), t.device.type)
                for loader in (train, valid) for t in loader.resident()]
    want_resident = [("torch.uint8", TRAINER_TRAIN * 3072, "cuda"),
                     ("torch.int32", TRAINER_TRAIN * 4, "cuda"),
                     ("torch.uint8", TRAINER_VALID * 3072, "cuda"),
                     ("torch.int32", TRAINER_VALID * 4, "cuda")]
    ok_route = (isinstance(train, DeviceCacheLoader) and isinstance(valid, DeviceCacheLoader)
                and train.augment and not valid.augment and resident == want_resident)
    say(f"(iii) DataMngr routes: train {type(train).__name__} (augment {train.augment}), valid "
        f"{type(valid).__name__}; the splits on the card (dtype, bytes, device): {resident} "
        f"{'ok' if ok_route else 'FAIL'}")
    if not ok_route:
        failures.append(f"augmented fit routes/residency: {type(train)}, {resident}")

    trainer = Trainer(build_model("resnet", setting, device=DEVICE))
    n = conv_count(trainer.model)
    calls, epoch_s = {"train": [], "eval": []}, []
    count_calls(trainer, calls)
    timed_train_epochs(trainer, epoch_s)
    sync()
    kernels.reset_launches()
    trainer.fit(train, valid)
    sync()
    fit_launches = dict(kernels.LAUNCHES)
    check_routes("RN26@32 augmented fit", fit_launches, failures)
    trainer.close()
    r = trainer.epoch_results
    per_step = launches_of({"conv2d_stats": n, "conv2d_stats_reduce": n, "max_pool2d": 1,
                            "pool2d_backward": 1, **bn_sites(n)})
    per_eval = launches_of({"conv2d_fused": n, "max_pool2d": 1})
    ok_calls = (len(calls["train"]) == len(train) * AUG_EPOCHS
                and len(calls["eval"]) == len(valid) * AUG_EPOCHS
                and all(c == per_step for c in calls["train"])
                and all(c == per_eval for c in calls["eval"]))
    ok_learn = (r["train_loss"][-1] < r["train_loss"][0] and r["valid_score"][-1] > TRAINER_MIN_ACC
                and bool(np.isfinite(r["train_loss"]).all()))
    rates = [TRAINER_TRAIN / t for t in epoch_s]
    say(f"(iii) augmented fit RN26@32 bf16 (affine, cutout {AUG_CUTOUT}, mixup {AUG_MIXUP}), "
        f"{AUG_EPOCHS} epochs: train loss {r['train_loss']}, valid acc {r['valid_score']} (> "
        f"{TRAINER_MIN_ACC}) {'ok' if ok_learn else 'FAIL'}; {len(calls['train'])} train steps "
        f"each { {k: v for k, v in per_step.items() if v} }, {len(calls['eval'])} eval batches "
        f"each { {k: v for k, v in per_eval.items() if v} } {'ok' if ok_calls else 'FAIL'}; "
        f"epoch img/s {[round(v, 1) for v in rates]}")
    if not ok_calls:
        failures.append(f"augmented fit launches per call off: "
                        f"{[c for c in calls['train'] if c != per_step][:1]}")
    if not ok_learn:
        failures.append(f"augmented fit: loss {r['train_loss']}, acc {r['valid_score']}")
    res.update(train_loss=r["train_loss"], valid_score=r["valid_score"], epoch_img_s=rates,
               launches_per_train_step={k: v for k, v in per_step.items() if v})

    # (iv) fit → export → serve
    stats = trainer._resolve_stats(train)
    path = os.path.join(out_dir, "rn26_fit.bin")
    meta = export_trainer(trainer, path, stats=stats, input_dtype="uint8")
    served = load_artifact(path)
    preds = []
    get_eval = trainer._get_eval_step

    def capturing(*a, **k):
        fn = get_eval(*a, **k)

        def step(x, y, w=None):
            out = fn(x, y, w)
            preds.append((out[2], w))
            return out
        return step

    trainer._get_eval_step = capturing
    _, _, fps = trainer.test(valid, num_warmup=2)
    trainer._get_eval_step = get_eval
    tested = torch.cat([p[w > 0] for p, w in preds[-len(valid):]]).cpu().numpy()
    art = np.concatenate([served.predict(valid_ds.images[i:i + TRAINER_BATCH])
                          for i in range(0, TRAINER_VALID, TRAINER_BATCH)])
    agree = float((art == tested).mean())
    ok_art = agree >= ARGMAX_MIN and len(tested) == TRAINER_VALID
    say(f"(iv) fit → export ({meta['payload_bytes']} B payload) → serve the valid split: "
        f"artifact argmax = Trainer.test's on {agree:.4f} of {len(tested)} images (min "
        f"{ARGMAX_MIN}); Trainer.test {fps:.1f} img/s {'ok' if ok_art else 'FAIL'}")
    if not ok_art:
        failures.append(f"fit → export → serve agreement {agree} over {len(tested)}")
    res.update(fit_artifact_agreement=agree, test_img_s=fps)

    # (iii) one profiled epoch of the replayed graph (captured again by an
    # epoch before it: fit ends by loading its best checkpoint, which drops
    # the graphs): its only host-to-device copies are the epoch's index and
    # weight matrices, sent before the first replay; the idle share
    Trainer._run_train_epoch(trainer, train, 98)  # not the timed wrapper
    sync()
    prof, host, copies, memcpys = profiled_epoch(
        lambda: Trainer._run_train_epoch(trainer, train, 99))
    device, ours, _ = device_split(prof, OUR_KERNELS)
    idle = 1.0 - device / 1e6 / host
    matrix_bytes = len(train) * TRAINER_BATCH * 4
    ok_copies = copies_ok(copies, memcpys, matrix_bytes) and device > 0
    say(f"(iii) profiled augmented epoch, replayed ({len(train)} steps): device "
        f"{device / 1e3:.3f} ms of {1e3 * host:.3f} ms host clock, idle share {idle:.4f}; the "
        f"port's kernels {ours / 1e3:.3f} ms; {copies_text(copies, memcpys, matrix_bytes)} "
        f"{'ok' if ok_copies else 'FAIL'}")
    if not ok_copies:
        failures.append(f"augmented epoch H2D copies {copies[:8]} ({len(copies)}), memcpy "
                        f"calls {memcpys}")

    # the preprocessing's share of a step's device time (the step is
    # host-bound, so each is read from the profiler, not from time_ms)
    x, y, w = next(iter(train))
    rng = data_rng(seed, DEVICE, 0, 0)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    pre = _make_preprocess(trainer.model, True, stats, augment=True, cut=AUG_CUTOUT)
    step = trainer._get_train_step(True, True, False, stats)
    dev_ms = {}
    for name, fn in (("preprocess", lambda: pre(x, rng)),
                     ("step", lambda: step(trainer.state, x, y, w, gen, rng))):
        fn()
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            sync()
        dev_ms[name] = device_split(prof, OUR_KERNELS)[0] / 3e3
    pre_ms, step_ms = dev_ms["preprocess"], dev_ms["step"]
    say(f"(iii) one augmented step at b{TRAINER_BATCH}: {step_ms:.3f} ms device time, of it the "
        f"preprocessing (dequantize, crop + flip + affine, normalize, cutout) {pre_ms:.3f} ms "
        f"({100 * pre_ms / step_ms:.2f}%)")
    res.update(profiled_epoch={"host_ms": 1e3 * host, "device_ms": device / 1e3,
                               "idle_share": idle, "kernels_ms": ours / 1e3,
                               "h2d_copies": len(copies), "h2d_bytes": sorted(set(copies)),
                               "memcpy_calls_before_during_after_replays": memcpys},
               step_ms=step_ms, preprocess_ms=pre_ms)
    return res, fit_launches, calls["train"][:len(train) * AUG_EPOCHS]


SERVE_RATE_ITERS = 20


def serve_rate(seed):
    """--serve-rate: RN50@224 bf16 from build_model's seeded init, served
    by the live ServingModel (uint8 requests from the host, baked ImageNet
    normalization) at b64 and b256: host seconds around SERVE_RATE_ITERS
    requests after 3 warm-ups, fenced. Uses only build_model, Settings
    and ServingModel(model, input_dtype=, stats=), which older checkouts
    of the port have too."""
    import torch

    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.serve import ServingModel

    model = build_model("resnet", model_setting("resnet", seed, True))
    server = ServingModel(model, input_dtype="uint8", stats=IMAGENET_STATS)
    rng = np.random.default_rng(seed)
    out = {}
    for b in (64, 256):
        req = rng.integers(0, 256, (b, IMAGE, IMAGE, 3), dtype=np.uint8)
        for _ in range(3):
            server(req)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_RATE_ITERS):
            server(req)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / SERVE_RATE_ITERS
        out[f"b{b}"] = {"img_s": b / dt, "ms": 1e3 * dt}
    return out


TRAIN_PROFILE_DEPTH = (3, 10)  # --train-profile: warm-up and timed steps
TRAIN_PROFILE_STEPS = 3  # --train-profile: steps under the profiler
FUSED_BWD = "autograd::engine::evaluate_function: _ConvBNReLUTrainBackward"
# the conv main loops as the profiler names them: in a train step of a
# model whose convs are all fused sites, only the statistics convs (row 5
# / 5g) launch them
CONV_MAIN_LOOPS = ("conv_wgmma_kernel<", "conv_kernel<", "grouped_conv_kernel<")


def train_profile(seed):
    """--train-profile: the RN50@224 bf16 b256 train step with bench.py's
    settings (Adam, weight decay 1e-4, dropout 0.5, a uint8 batch on the
    card) of the port first on sys.path: ms per step (host clock, fenced),
    then TRAIN_PROFILE_STEPS steps under torch.profiler, their device ms
    per step split into the statistics convs' main loops (CONV_MAIN_LOOPS,
    by name), the fused sites' BN forward (the rest of what
    kernels.conv_bn_relu_train launches, under a range: the statistics'
    53 fixed-order reductions with it), the BN backward
    (the _ConvBNReLUTrainBackward nodes less their
    aten::convolution_backward; their kernels by name, kernels_under), the
    backward convs and the rest, and the device kernels per step; then
    the RN26@32 bf16 b256 step's img/s (step_loop_rate), the grouped
    sites' times (grouped_site_times), ShuffleNet-v1-g4@224's step and
    request (shuffle_profile) and the world of one (mesh_profile). Uses
    only what checkouts of the port since its data-parallel slice have
    too."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.ops import kernels

    model = build_model("resnet", model_setting("resnet", seed, True))
    state, step = train_state(model)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    batch = TRAIN_BATCH["resnet"]
    x = torch.randint(0, 256, (batch, IMAGE, IMAGE, 3), dtype=torch.uint8, device=DEVICE,
                      generator=gen)
    y = torch.randint(0, 1000, (batch,), device=DEVICE, generator=gen)
    kernels.reset_launches()
    seconds = timed_steps(step, state, x, y, gen, TRAIN_PROFILE_DEPTH)[0]
    launches = {k: v / sum(TRAIN_PROFILE_DEPTH) for k, v in kernels.LAUNCHES.items() if v}

    def ranged(label, fn):
        def call(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        return call

    saved = {"conv_bn_relu_train": kernels.conv_bn_relu_train}
    for name, fn in saved.items():
        setattr(kernels, name, ranged(name, fn))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(TRAIN_PROFILE_STEPS):
                step(state, x, y, generator=gen)
            sync()
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)
    per = TRAIN_PROFILE_STEPS
    events = prof.events()

    def host_ms(name):
        return sum(float(getattr(e, "device_time_total", 0.0) or 0.0) for e in events
                   if e.name == name and getattr(e, "device_type", None) == DeviceType.CPU
                   ) / per / 1e3

    device = [e for e in events if getattr(e, "device_type", None) == DeviceType.CUDA
              and e.name not in saved]
    device_ms = sum(float(getattr(e, "device_time_total", 0.0) or 0.0) for e in device) / per / 1e3
    def named_ms(*names):
        return sum(float(getattr(e, "device_time_total", 0.0) or 0.0) for e in device
                   if any(n in e.name for n in names)) / per / 1e3

    loops_ms, reduce_ms = named_ms(*CONV_MAIN_LOOPS), named_ms("stats_reduce_kernel")
    bn_act_ms = named_ms("bn_act_")
    site_ms = host_ms("conv_bn_relu_train")
    bwd_node_ms, conv_bwd_ms = host_ms(FUSED_BWD), host_ms("aten::convolution_backward")
    split = {"device_ms": device_ms, "conv_main_loops_ms": loops_ms,
             "bn_forward_ms": site_ms - loops_ms, "bn_backward_ms": bwd_node_ms - conv_bwd_ms,
             "bn_act_kernels_ms": bn_act_ms, "stats_reduce_kernels_ms": reduce_ms,
             "conv_backward_ms": conv_bwd_ms, "other_ms": device_ms - site_ms - bwd_node_ms,
             "device_events_per_step": len(device) / per,
             "bn_backward_kernels": kernels_under(events, FUSED_BWD, per,
                                                  skip=("aten::convolution_backward",))}
    say(f"train profile: RN50@224 bf16 b{batch}: {1e3 * seconds:.2f} ms per step "
        f"({batch / seconds:.1f} img/s); device per step {device_ms:.3f} ms: the statistics "
        f"convs' main loops {loops_ms:.3f}, BN forward {split['bn_forward_ms']:.3f}, BN backward "
        f"{split['bn_backward_ms']:.3f} (of the two: the bn_act kernels {bn_act_ms:.3f}, the "
        f"reductions {reduce_ms:.3f}), backward convs {conv_bwd_ms:.3f}, the rest "
        f"{split['other_ms']:.3f}; "
        f"{split['device_events_per_step']:.0f} device events per step; the BN backward "
        f"nodes' kernels outside aten::convolution_backward, ms per step and calls: "
        f"{split['bn_backward_kernels']}")
    del model, state, step, x, y
    torch.cuda.empty_cache()
    return {"rn50_b256": {"ms_per_step": 1e3 * seconds, "img_s": batch / seconds,
                          "launches_per_step": launches, **split},
            "rn26_32_b256_img_s": step_loop_rate(seed),
            "grouped_sites": grouped_site_times(seed),
            "shufflenet_g4_224": shuffle_profile(seed),
            "world_of_one": mesh_profile(seed)}


def kernels_under(events, name, per, skip=()):
    """{kernel name: [device ms per step, launches per step]} of the device
    kernels launched under the host ops called `name` (their children
    included, but not those under an op named in `skip`), largest first:
    at most 8 names, the rest summed under "rest"."""
    totals = {}

    def walk(e):
        if e.name in skip:
            return
        for k in e.kernels:
            t = totals.setdefault(k.name[:60], [0.0, 0])
            t[0] += k.duration / 1e3 / per
            t[1] += 1 / per
        for c in e.cpu_children:
            walk(c)

    for e in events:
        if e.name == name:
            walk(e)
    return top_names(totals)


GROUPED_SITE_REPS = 20  # --train-profile: calls per time_ms of a grouped site


def grouped_site_times(seed):
    """--train-profile: row 6's grouped conv_bn_relu_train, bf16, forward +
    backward (dx, dw, dscale, dbias for one cotangent), GROUPED_SITE_REPS
    calls per time_ms: phase 8's two N=8 shapes, and at B256 every grouped
    shape of the main path's ResNeXt@224 summed by uses; then one profiled
    call of each B256 shape, its device kernels by name (ms per step of
    the model's grouped sites)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.ops import kernels

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    model = build_model("resnext", model_setting("resnext", seed, True), device=DEVICE)
    shapes = distinct_shapes(model, ("gconv",))
    del model

    def site(n, h, cin, cout, k, s, p, groups):
        x = torch.randn(n, h, h, cin, device=DEVICE, generator=g).to(torch.bfloat16)
        w = (torch.randn(k, k, cin // groups, cout, device=DEVICE, generator=g)
             / np.sqrt(k * k * cin // groups)).to(torch.bfloat16)
        sc = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        bi = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        ins = [t.requires_grad_() for t in (x, w, sc, bi)]
        out = kernels.conv_bn_relu_train(*ins, s, p, groups=groups)[0]
        cot = torch.randn(out.shape, device=DEVICE, generator=g).to(out.dtype)
        del out

        def run():
            return torch.autograd.grad(kernels.conv_bn_relu_train(*ins, s, p, groups=groups)[0],
                                       ins, cot)
        return run

    res = {"n8_ms": {}, "b256_ms": 0.0}
    for h, c, s in ((IMAGE // 4, 128, 1), (IMAGE // 4, 256, 2)):
        res["n8_ms"][f"{h} {c} {c} {s} 32"] = time_ms(site(8, h, c, c, 3, s, 1, 32),
                                                      GROUPED_SITE_REPS)
    runs = {key: site(B256, key[0], *key[2:]) for key in sorted(shapes)}
    for key, run in runs.items():
        res["b256_ms"] += len(shapes[key]) * time_ms(run, GROUPED_SITE_REPS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for key, run in runs.items():
            for _ in shapes[key]:
                run()
        sync()
    res["b256_kernels"] = events_by_name(prof.events(), 1)
    say(f"train profile: grouped conv_bn_relu_train bf16 fwd+bwd ({GROUPED_SITE_REPS} calls "
        f"each): N=8 {res['n8_ms']} ms; B{B256} at the main path's ResNeXt@224 grouped "
        f"shapes {sorted(shapes)} summed by uses {res['b256_ms']:.4f} ms; its device events "
        f"by name (ms, events per step of the grouped sites): {res['b256_kernels']}")
    del runs
    torch.cuda.empty_cache()
    return res


SHUFFLE_SERVE_ITERS = 10  # --train-profile: timed b256 requests of ShuffleNet-g4@224


def shuffle_profile(seed):
    """--train-profile: ShuffleNet-v1-g4 at 3x224x224, 1000 classes, its
    bf16 b256 train step with bench.py's settings (Adam, weight decay 1e-4,
    dropout 0.5, a uint8 batch on the card): host ms per step (timed_steps
    at TRAIN_PROFILE_DEPTH), then TRAIN_PROFILE_STEPS steps under
    torch.profiler: device ms per step and, by name, the device kernels of
    the grouped convs (every device event whose name has "grouped") per
    step; then its b256 uint8 request to the live ServingModel: host ms
    per request (SHUFFLE_SERVE_ITERS after two warm-ups, fenced) and one
    profiled request's device ms, the grouped kernels by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.serve import ServingModel
    from convnets_tpu_torch.settings import Settings

    setting = Settings(kind="g4", input_size=(3, IMAGE, IMAGE), num_classes=1000,
                       batch_norm=True, init_params=True, dropout_rate=0.5, mixed_precision=True,
                       seed=seed, learning_rate=0.01, weight_decay=1e-4, optimizer="adam")
    model = build_model("shufflenet_v1", setting)
    state, step = train_state(model)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randint(0, 256, (B256, IMAGE, IMAGE, 3), dtype=torch.uint8, device=DEVICE,
                      generator=gen)
    y = torch.randint(0, 1000, (B256,), device=DEVICE, generator=gen)
    seconds = timed_steps(step, state, x, y, gen, TRAIN_PROFILE_DEPTH)[0]

    def device_ms(prof, per):
        events = [e for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA]
        total = sum(float(getattr(e, "device_time_total", 0.0) or 0.0) for e in events)
        grouped = {}
        for e in events:
            if "grouped" in e.name:
                t = grouped.setdefault(e.name[:60], [0.0, 0])
                t[0] += float(getattr(e, "device_time_total", 0.0) or 0.0) / 1e3 / per
                t[1] += 1 / per
        return total / 1e3 / per, grouped

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TRAIN_PROFILE_STEPS):
            step(state, x, y, generator=gen)
        sync()
    step_ms, step_grouped = device_ms(prof, TRAIN_PROFILE_STEPS)
    model.eval()
    server = ServingModel(model, input_dtype="uint8", stats=IMAGENET_STATS)
    req = np.random.default_rng(seed).integers(0, 256, (B256, IMAGE, IMAGE, 3), dtype=np.uint8)
    serve_s = seconds_per_request(server, req, SHUFFLE_SERVE_ITERS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        server(req)
        sync()
    serve_ms, serve_grouped = device_ms(prof, 1)
    res = {"step_host_ms": 1e3 * seconds, "step_img_s": B256 / seconds,
           "step_device_ms": step_ms, "step_grouped_kernels": step_grouped,
           "step_grouped_ms": sum(v[0] for v in step_grouped.values()),
           "request_host_ms": 1e3 * serve_s, "request_device_ms": serve_ms,
           "request_grouped_kernels": serve_grouped,
           "request_grouped_ms": sum(v[0] for v in serve_grouped.values())}
    say(f"train profile: ShuffleNet-v1-g4@224 bf16 b{B256}: {res['step_host_ms']:.2f} host ms per "
        f"step ({res['step_img_s']:.1f} img/s), device {step_ms:.3f} ms per step, of it the "
        f"grouped kernels {res['step_grouped_ms']:.3f} ({step_grouped}); the b{B256} request "
        f"{res['request_host_ms']:.2f} host ms, device {serve_ms:.3f} ms, of it the grouped "
        f"kernels {res['request_grouped_ms']:.3f} ({serve_grouped})")
    del model, state, step, server, x, y
    torch.cuda.empty_cache()
    return res


def events_by_name(events, per, top=8):
    """{name: [device ms per step, events per step]} of a profile's device
    events, largest first: `top` names, the rest summed under "rest"."""
    from torch.autograd import DeviceType

    totals = {}
    for e in events:
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            t = totals.setdefault(e.name[:60], [0.0, 0])
            t[0] += e.time_range.elapsed_us() / 1e3 / per
            t[1] += 1 / per
    return top_names(totals, top)


def top_names(totals, top=8):
    """{name: [ms, count]} rounded, largest ms first: `top` names, then
    the rest summed under "rest"."""
    ranked = sorted(totals.items(), key=lambda kv: -abs(kv[1][0]))
    out = {k: [round(v[0], 4), round(v[1], 2)] for k, v in ranked[:top]}
    if len(ranked) > top:
        out["rest"] = [round(sum(v[0] for _, v in ranked[top:]), 4),
                       round(sum(v[1] for _, v in ranked[top:]), 2)]
    return out


MESH_PROFILE_EPOCHS = 6  # --train-profile: replayed epochs per route, in turns


def mesh_profile(seed):
    """--train-profile: phase 16 (i)'s world-of-one RN26@32 replayed fit
    (NCCL), with the mesh and without: one epoch each that runs the eager
    steps and the capture, then MESH_PROFILE_EPOCHS replayed epochs each in
    turns (img/s), then one profiled replayed epoch each: device ms per
    step (the sum of the device events), the busy ms (their union) and
    the span (first start to last end) per step, and the device events by
    name where the two routes differ, mesh less no mesh, in ms and events
    per step."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType

    from convnets_tpu_torch.data import ArrayDataset, DeviceCacheLoader
    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.parallel import init_distributed, make_mesh
    from convnets_tpu_torch.train import Trainer

    routes = ("no_mesh", "mesh")
    with tempfile.TemporaryDirectory() as out_dir:
        init_distributed("file://" + os.path.join(out_dir, "nccl-store"), 1, 0, device=DEVICE)
        try:
            mesh = make_mesh()
            train_ds, _ = trainer_data(seed)
            train_ds = ArrayDataset(train_ds.images[:GRAPH_TRAIN], train_ds.labels[:GRAPH_TRAIN])
            setting = trainer_setting(seed, out_dir, data_augment=True, augment_affine=True,
                                      data_norm=True, cutout=AUG_CUTOUT, mixup=AUG_MIXUP)
            trainers, loaders, first = {}, {}, None
            for name in routes:
                model = build_model("resnet", setting, device=DEVICE)
                if first is None:
                    first = model.state_dict()
                model.load_state_dict(first)
                trainers[name] = Trainer(model, mesh=mesh if name == "mesh" else None)
                trainers[name]._new_state()
                loaders[name] = DeviceCacheLoader(train_ds, TRAINER_BATCH, shuffle=True,
                                                  seed=seed, device=DEVICE)
                loaders[name].augment, loaders[name].normalize = True, True
            rates = {name: [] for name in routes}
            for e in range(MESH_PROFILE_EPOCHS + 1):
                for name in routes if e % 2 == 0 else routes[::-1]:
                    sync()
                    t0 = time.perf_counter()
                    trainers[name]._run_train_epoch(loaders[name], e)
                    sync()
                    if e:
                        rates[name].append(GRAPH_TRAIN / (time.perf_counter() - t0))
            steps = len(loaders["mesh"])
            prof = {}
            for name in routes:
                prof[name] = profiled_epoch(lambda name=name: trainers[name]._run_train_epoch(
                    loaders[name], MESH_PROFILE_EPOCHS + 1))[0]
        finally:
            dist.destroy_process_group()
    res = {"epochs_img_s": rates}
    by_name = {}
    for name in routes:
        dev = [e for e in prof[name].events()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
        busy, reach = 0.0, None
        for a, b in spans:
            if reach is None or a > reach:
                busy += b - a
                reach = b
            elif b > reach:
                busy += b - reach
                reach = b
        res[name] = {"device_ms_per_step": sum(e.time_range.elapsed_us() for e in dev)
                     / steps / 1e3,
                     "busy_ms_per_step": busy / steps / 1e3,
                     "span_ms_per_step": (spans[-1][1] - spans[0][0] if spans else 0.0)
                     / steps / 1e3}
        for e in dev:
            t = by_name.setdefault(e.name[:60], {r: [0.0, 0] for r in routes})[name]
            t[0] += e.time_range.elapsed_us() / steps / 1e3
            t[1] += 1 / steps
    res["mesh_less_no_mesh"] = top_names(
        {k: [v["mesh"][0] - v["no_mesh"][0], v["mesh"][1] - v["no_mesh"][1]]
         for k, v in by_name.items() if v["mesh"] != v["no_mesh"]})
    say(f"train profile: world-of-one RN26@32 replayed epochs in turns ({steps} steps each), "
        f"img/s {({k: [round(r, 1) for r in v] for k, v in rates.items()})}; profiled epoch "
        f"per step: " + "; ".join(f"{name} device {res[name]['device_ms_per_step']:.4f} ms, "
                                  f"busy {res[name]['busy_ms_per_step']:.4f}, span "
                                  f"{res[name]['span_ms_per_step']:.4f}" for name in routes)
        + f"; events by name, mesh less no mesh (ms, events per step): "
        f"{res['mesh_less_no_mesh']}")
    del trainers, loaders
    torch.cuda.empty_cache()
    return res


def phase_artifact(seed, card, failures):
    """Phase 11: (i)-(ii) the RN50 artifact, (iii)-(iv) the augmented fit,
    its export and its profile, (v) the augmentation on the card. Prints
    the artifact JSON line; returns the launches of the artifact's b256
    request and of the augmented fit, and the fit's per-call launches."""
    parts, out = {}, {"card": card}
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        out["artifact"], served = artifact_check(seed, out_dir, failures)
        out["cross_device_rel"] = cross_device_check(seed, out_dir, failures)
        parts["i_ii"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["augmented_fit"], fit, fit_calls = aug_fit_check(seed, out_dir, failures)
        parts["iii_iv"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["augmentation_vs_cpu"] = aug_card_check(seed, failures)
    out["rrc_step"] = rrc_step_check(seed, failures)
    parts["v"] = time.perf_counter() - t0
    out["seconds"] = parts
    say(json.dumps({"artifact": out}))
    return served, fit, fit_calls


# phase 12: the zoo's first group, the CLI and the tuner. (arch, kind, image
# side): each family at 3x32x32, the CINIC shape the reference trains it on,
# and SqueezeNet 1.0 at 224² (at 32² its third 3x3/2 pool sees 2x2)
ZOO = (("lenet", "0", 32), ("convnet", "0", 32), ("mynetwork", "base", 32),
       ("vggnet", "16", 32), ("squeezenet", "1.1", 32), ("inceptionnet_v1", "v1", 32),
       ("squeezenet", "1.0", 224))
ZOO_CLASSES = 10
ZOO_BATCH = 8  # (i): fp32 logits, the SGD step, the layer check (with CLI_FAMILY_BATCH)
ZOO_FP32_TOL = 1e-4  # (i): fp32 eval logits, |Δ| ≤ tol · max |logit|
ZOO_LEARN_LR = 1e-3  # (i): Adam on one batch of LEARN_BATCH
# the step check's leaves whose true gradient is 0 by construction:
# ShuffleNet's depthwise BN bias feeds the expand conv's BN, whose batch mean
# removes any per-channel constant, so every path (and the control) holds
# only rounding noise there (|g| ~1e-7 beside leaf gradients of ~1, and the
# control's own ‖Δ‖/‖g‖ there is ~1.5); each is held to STEP_GRAD_TOL of the
# step's median leaf norm instead of its own
CANCELLED_LEAVES = {"shufflenet_v1": ("depthwise.1.bias",)}
ZOO_SERVE_BATCH = 256
# zoo_family's timed requests a turn (10 until phase 17 was added)
ZOO_SERVE_ITERS = 6
# (ii): the CINIC-shaped PNG tree the CLI reads: images per split, 10 classes
CLI_SPLITS = (("train", 2560), ("valid", 640), ("test", 640))
CLI_BATCH, CLI_EPOCHS, CLI_RESUME_EPOCHS = 256, 2, 3
CLI_FAMILY_BATCH, CLI_FAMILY_EPOCHS = 128, 2
# (iii): process_tune on mynetwork; with seed 0 the three samples draw
# batch_norm False, False, True (so both the conv2d_stats and the
# conv2d_train step run) and learning rates 1.5e-3, 1.6e-3, 5.0e-3
TUNE_SEED, TUNE_SAMPLES = 0, 3
# (ii): a fresh process serves the exported artifact on the test split;
# argv: repository root, artifact path, .npy of uint8 images
CLI_CHILD = """
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import torch
from convnets_tpu_torch.ops import kernels
from convnets_tpu_torch.serve import load_artifact
served = load_artifact(sys.argv[2])
x = np.load(sys.argv[3])
kernels.reset_launches()
preds = [served(x[i:i + 256].astype(np.float32) / 255.0).argmax(-1).cpu().numpy()
         for i in range(0, len(x), 256)]
torch.cuda.synchronize()
print(json.dumps({"argmax": np.concatenate(preds).tolist(),
                  "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
                  "meta": {k: served.meta[k] for k in ("model_name", "normalization_baked",
                                                       "input_dtype", "batch")}}))
"""


def model_launches(model):
    """(per eval forward, per train step) launches of a model, read off its
    modules (model_layers): per forward one conv2d_fused for each dense
    conv, one grouped_conv2d_fused for each grouped one, one
    depthwise_conv2d for each depthwise one, one max_pool2d / avg_pool2d
    for each pool; per train step one conv2d_stats (grouped_conv2d_stats),
    one reduction and the four BN-pass launches (bn_sites) for each dense
    (grouped) ConvBNReLU, the forward
    kernel of each conv without BN (conv2d_train, grouped_conv2d_train) and
    of each depthwise conv (its ConvBNReLU runs unfused), and each pool's
    forward and one pool2d_backward."""
    kinds = [layer[0] for layer in model_layers(model)]
    n = {k: kinds.count(k) for k in ("conv", "gconv", "dwconv", "plainconv", "plaingconv",
                                     "plaindwconv", "maxpool", "avgpool")}
    common = {"conv2d_fused": n["plainconv"], "grouped_conv2d_fused": n["plaingconv"],
              "depthwise_conv2d": n["dwconv"] + n["plaindwconv"], "max_pool2d": n["maxpool"],
              "avg_pool2d": n["avgpool"]}
    return (launches_of({**common, "conv2d_fused": n["conv"] + n["plainconv"],
                         "grouped_conv2d_fused": n["gconv"] + n["plaingconv"]}),
            launches_of({**common, "conv2d_stats": n["conv"], "grouped_conv2d_stats": n["gconv"],
                         "conv2d_stats_reduce": n["conv"] + n["gconv"],
                         "pool2d_backward": n["maxpool"] + n["avgpool"],
                         **bn_sites(n["conv"] + n["gconv"])}))


def grouped_routes_want(model):
    """(per eval forward, per train step) bf16 launches of the grouped conv
    wrappers per route, read off the model's grouped convs (model_layers)
    through grouped_plan: per forward one grouped_conv2d_fused for each,
    per step one grouped_conv2d_stats for each fused site and one
    grouped_conv2d_fused for each grouped conv without BN."""
    import torch

    from convnets_tpu_torch.ops import kernels

    fwd = {name: {"wgmma": 0, "wgmma_wide": 0, "simt": 0} for name in GROUPED_ROUTED}
    step = {name: dict(v) for name, v in fwd.items()}
    for kind, _, _, cin, cout, _, _, _, _, g in model_layers(model):
        if kind in ("gconv", "plaingconv"):
            route = kernels.grouped_plan(torch.bfloat16, cin, cout, g).route
            fwd["grouped_conv2d_fused"][route] += 1
            step["grouped_conv2d_stats" if kind == "gconv" else "grouped_conv2d_fused"][route] += 1
    return fwd, step


def grouped_routes():
    """The grouped conv wrappers' launches per route since the last reset."""
    from convnets_tpu_torch.ops import kernels

    return {name: dict(kernels.ROUTE_LAUNCHES[name]) for name in GROUPED_ROUTED}


def zoo_model(arch, kind, image, seed, conv_gain=None, **kw):
    """The family at image² with 10 classes on the card, numpy weights from
    `seed` in the JAX layout loaded by the bridge (conv_gain: as
    random_jax_variables takes it, for a net without BN)."""
    from convnets_tpu_torch import bridge
    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.settings import Settings

    fields = dict(kind=kind, input_size=(3, image, image), num_classes=ZOO_CLASSES,
                  batch_norm=True, init_params=True, dropout_rate=0.5, mixed_precision=True,
                  seed=seed, learning_rate=ZOO_LEARN_LR, weight_decay=1e-4, optimizer="adam")
    fields.update(kw)
    model = build_model(arch, Settings(**fields), device=DEVICE)
    bridge.load_jax_variables(model, random_jax_variables(model, seed, conv_gain))
    return model


def zoo_family(arch, kind, image, seed, card, failures):
    """Phase 12 (i) for one family: fp32 eval logits kernel vs plain at
    b8, phase 5 (i)'s fp32 SGD step at b8, ten bf16 Adam steps on one batch
    of 32 (both paths; the kernel path's loss must fall; the launches of
    its first step), the launches of one bf16 eval forward (the grouped
    ones also per route, grouped_routes_want), and serving img/s at b256
    (uint8 requests, kernel and plain paths in turns).
    The b256 request's logits are also held against the plain path's.
    Returns (summary, the fp32 model for the layer check)."""
    import torch

    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.serve import ServingModel

    label = f"{arch}{kind}@{image}"
    res = {}
    model32 = zoo_model(arch, kind, image, seed, mixed_precision=False)
    want_fwd, want_step = model_launches(model32)
    want_routes = grouped_routes_want(model32)
    gflop = forward_gflop(model32) + forward_linear_gflop(model32)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.rand(ZOO_BATCH, image, image, 3, device=DEVICE, generator=g)
    with torch.inference_mode():
        y32 = model32(x)
        with plain_kernels():
            r32 = model32(x)
    rel = float((y32 - r32).abs().max() / r32.abs().max())
    ok = rel <= ZOO_FP32_TOL and bool(torch.isfinite(y32).all())
    say(f"{label}: {gflop:.4f} GFLOP/img forward (convs and classifier); fp32 eval logits (b"
        f"{ZOO_BATCH}) vs plain: max |Δ| / max |logit| {rel:.3e} (tol {ZOO_FP32_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{label} fp32 logits rel {rel:.3e}")
    res.update(gflop_forward=gflop, fp32_logits_rel=rel)

    res["step"] = step_check(label, seed, failures, batch=ZOO_BATCH, image=image,
                             classes=ZOO_CLASSES,
                             make=lambda **kw: zoo_model(arch, kind, image, seed, **kw),
                             cancelled=CANCELLED_LEAVES.get(arch, ()))

    rng = np.random.default_rng(seed + 3)
    xb = torch.from_numpy(rng.integers(0, 256, (LEARN_BATCH, image, image, 3),
                                       dtype=np.uint8)).to(DEVICE)
    yb = torch.from_numpy(rng.integers(0, ZOO_CLASSES, LEARN_BATCH)).to(DEVICE)
    losses, step_launches = {}, None
    for path in ("plain", "kernel"):
        model = zoo_model(arch, kind, image, seed, dropout_rate=0.0)
        state, step = train_state(model, norm=True, stats=IMAGENET_STATS)
        with plain_kernels() if path == "plain" else contextlib.nullcontext():
            sync()
            kernels.reset_launches()
            losses[path] = [float(step(state, xb, yb)[0])]
            sync()
            if path == "kernel":
                step_launches, step_routes = dict(kernels.LAUNCHES), grouped_routes()
            losses[path] += [float(step(state, xb, yb)[0]) for _ in range(LEARN_STEPS - 1)]
    falls = losses["kernel"][-1] < losses["kernel"][0] and all(np.isfinite(losses["kernel"]))
    say(f"{label}: {LEARN_STEPS} bf16 Adam steps (lr {ZOO_LEARN_LR:g}) on one batch of "
        f"{LEARN_BATCH}, loss per step:\n  kernel {[round(v, 3) for v in losses['kernel']]}\n"
        f"  plain  {[round(v, 3) for v in losses['plain']]}\n  kernel path's loss falls: "
        f"{'ok' if falls else 'FAIL'}")
    if not falls:
        failures.append(f"{label} bf16 loss did not fall: {losses['kernel']}")

    model.eval()
    xe = torch.rand(ZOO_BATCH, image, image, 3, device=DEVICE, generator=g)
    with torch.inference_mode():
        model(xe)
        sync()
        kernels.reset_launches()
        model(xe)
        sync()
    fwd_launches, fwd_routes = dict(kernels.LAUNCHES), grouped_routes()
    ok = fwd_launches == want_fwd and step_launches == want_step
    say(f"{label}: launches per bf16 eval forward {launches_summary(fwd_launches)}, per train "
        f"step {launches_summary(step_launches)} (expected {launches_summary(want_fwd)} and "
        f"{launches_summary(want_step)}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{label} launches: forward {fwd_launches}, step {step_launches}")
    routes = {"forward": fwd_routes, "step": step_routes}
    if any(n for per in want_routes for v in per.values() for n in v.values()):
        ok = (fwd_routes, step_routes) == want_routes
        say(f"{label}: grouped launches per route, forward {fwd_routes}, step {step_routes} "
            f"(expected {want_routes[0]} and {want_routes[1]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{label} grouped routes: forward {fwd_routes}, step {step_routes}")
    res.update(learn=losses, launches_forward=launches_summary(fwd_launches),
               launches_step=launches_summary(step_launches), grouped_routes=routes)

    server = ServingModel(model, input_dtype="uint8", stats=IMAGENET_STATS)
    req = rng.integers(0, 256, (ZOO_SERVE_BATCH, image, image, 3), dtype=np.uint8)
    got = server(req)
    with plain_kernels():
        ref = server(req)
    sync()
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    top2 = ref.topk(2, dim=-1).values
    diff, scale = float((got - ref).abs().max()), float(ref.abs().max())
    ok = agree >= ARGMAX_MIN and bool(torch.isfinite(got).all())
    say(f"{label}: served bf16 b{ZOO_SERVE_BATCH} logits vs plain: argmax agreement {agree:.4f} "
        f"(min {ARGMAX_MIN}) {'ok' if ok else 'FAIL'}; max |logit diff| {diff:.4e} (max |logit| "
        f"{scale:.4e}), smallest top-2 gap {float((top2[:, 0] - top2[:, 1]).min()):.4e}, "
        f"distinct argmax classes {ref.argmax(-1).unique().numel()} (plain)")
    if not ok:
        failures.append(f"{label} served b{ZOO_SERVE_BATCH} argmax agreement {agree:.4f}")
    res["serve_b256_vs_plain"] = {"argmax_agreement": agree, "max_abs_diff": diff,
                                  "max_abs_logit": scale}
    runs = {"kernel": [], "plain": []}
    for path in ("plain", "kernel", "kernel", "plain"):  # in turns, one card
        with plain_kernels() if path == "plain" else contextlib.nullcontext():
            runs[path].append(seconds_per_request(server, req, ZOO_SERVE_ITERS))
    rates = {p: ZOO_SERVE_BATCH / float(np.mean(v)) for p, v in runs.items()}
    say(f"{label}: serving bf16 b{ZOO_SERVE_BATCH} (uint8 requests from the host, live model): "
        f"kernel path {rates['kernel']:.1f} img/s (runs "
        f"{[round(1e3 * t, 2) for t in runs['kernel']]} ms), plain path {rates['plain']:.1f} "
        f"img/s ({card})")
    res["serve_img_s_b256"] = rates
    del model, state, server
    return res, model32


def launches_summary(launches):
    return {k: v for k, v in (launches or {}).items() if v}


def phase_zoo(seed, card, summary, failures):
    """Phase 12 (i): every family of ZOO (zoo_family), then layer_check over
    all their distinct conv and max-pool shapes at b8 in bf16 and fp32, and
    over those of the 32² families at CLI_FAMILY_BATCH in bf16, the batch of
    (ii)'s fits and (iii)'s tuner, where conv_plan picks other tiles."""
    import torch

    out, models = {}, []
    for arch, kind, image in ZOO:
        t0 = time.perf_counter()
        res, model = zoo_family(arch, kind, image, seed, card, failures)
        res["seconds"] = time.perf_counter() - t0
        out[f"{arch}{kind}@{image}"] = res
        models.append((image, model))
    distinct, covered = layer_check("zoo", [m for _, m in models],
                                    ((ZOO_BATCH, torch.bfloat16), (ZOO_BATCH, torch.float32)),
                                    summary, failures)
    out["layer_check"] = {"distinct_conv_shapes": distinct, "convs": covered}
    distinct, covered = layer_check("zoo 32² at the CLI's batch",
                                    [m for image, m in models if image == 32],
                                    ((CLI_FAMILY_BATCH, torch.bfloat16),), summary, failures)
    out["layer_check_cli_batch"] = {"distinct_conv_shapes": distinct, "convs": covered}
    return out


def write_cli_tree(root, seed):
    """CLI_SPLITS as PNG files under root/<split>/class<label>/, the images
    of synthetic_dataset(learnable=True) (its class signal does not depend
    on the seed) from seed + 20, + 21, + 22."""
    from PIL import Image

    from convnets_tpu_torch.data import synthetic_dataset

    for i, (split, n) in enumerate(CLI_SPLITS):
        ds = synthetic_dataset(n, (32, 32, 3), ZOO_CLASSES, seed=seed + 20 + i, learnable=True)
        images = (ds.images * 255).round().astype(np.uint8)
        for c in range(ZOO_CLASSES):
            os.makedirs(os.path.join(root, split, f"class{c}"))
        for j, (img, label) in enumerate(zip(images, ds.labels)):
            Image.fromarray(img).save(os.path.join(root, split, f"class{label}", f"{j:05d}.png"))


_CLI_TREES: dict = {}


def cli_tree(seed):
    """The root of write_cli_tree's PNG tree for `seed`, written once per
    run and shared by the phases that read it (12, 14, 16, 18), removed when
    the script exits."""
    if seed not in _CLI_TREES:
        import atexit

        tmp = tempfile.mkdtemp()
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
        root = os.path.join(tmp, "cinic_like")
        write_cli_tree(root, seed)
        _CLI_TREES[seed] = root
    return _CLI_TREES[seed]


@contextlib.contextmanager
def recorded_trainers(rec):
    """Every Trainer built inside (by the drivers): into rec["trainers"];
    the launches of each of its train and eval step calls into
    rec["train"] / rec["eval"]; its train epochs' seconds into
    rec["epoch_s"]; test()'s img/s into rec["test_img_s"]; and, while
    rec["capture"] is set, each eval call's (x, predictions, weights) on
    the host into rec["eval_io"]."""
    from convnets_tpu_torch.train import engine

    cls = engine.Trainer
    init, test = cls.__init__, cls.test

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        rec["trainers"].append(self)
        count_calls(self, rec)
        timed_train_epochs(self, rec["epoch_s"])

    def recording_test(self, *args, **kwargs):
        out = test(self, *args, **kwargs)
        rec["test_img_s"].append(out[2])
        return out

    cls.__init__, cls.test = recording_init, recording_test
    try:
        yield rec
    finally:
        cls.__init__, cls.test = init, test


def new_record():
    return {"trainers": [], "train": [], "eval": [], "epoch_s": [], "test_img_s": [],
            "eval_io": []}


def path_launches(totals, rec):
    """A path's launches per kernels-line entry: each kernel's own count,
    and the trainable functions by their kernels (conv_bn_relu_train by
    its conv2d_stats launches, pool2d_train by the max_pool2d launches of
    train steps, conv2d_train by the conv2d_fused launches of train steps)."""
    out = {k: totals[k] for k in ("conv2d_fused", "max_pool2d", "conv2d_stats",
                                  "conv2d_stats_reduce", "pool2d_backward", "bn_act_forward")}
    out["conv_bn_relu_train"] = totals["conv2d_stats"]
    out["bn_act_backward"] = totals["bn_act_backward_apply"]
    out["pool2d_train"] = sum(c["max_pool2d"] for c in rec["train"])
    train_fused = sum(c["conv2d_fused"] for c in rec["train"])
    if train_fused:
        out["conv2d_train"] = train_fused
    return out


def check_calls(label, rec, per_step, per_eval, failures):
    """Every train step call launched `per_step`, every eval call
    `per_eval`; returns whether they did."""
    ok = (bool(rec["train"]) and bool(rec["eval"])
          and all(c == per_step for c in rec["train"])
          and all(c == per_eval for c in rec["eval"]))
    say(f"    {label} launches: {len(rec['train'])} train steps each "
        f"{launches_summary(per_step)}, {len(rec['eval'])} eval calls each "
        f"{launches_summary(per_eval)}: {'ok' if ok else 'FAIL'}")
    if not ok:
        bad = ([c for c in rec["train"] if c != per_step][:1]
               + [c for c in rec["eval"] if c != per_eval][:1])
        failures.append(f"{label} launches per call off: {bad}")
    return ok


def finished(proc, timeout):
    """A CompletedProcess of `proc` once it exits; killed after `timeout` s
    (its output so far, and its return code then)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def phase_cli(seed, card, failures):
    """Phase 12 (ii)-(iii): the CLI on the card, in process through
    convnets_tpu_torch.__main__.main, on a CINIC-shaped PNG tree: RN26 fit →
    load --testing → load --resume → export --bake-norm, the artifact
    served by a fresh process against Trainer.test; each new family fitted
    for 2 epochs; `python -m convnets_tpu_torch` as a subprocess, with and
    without the card; then process_tune on mynetwork. Prints the cli JSON
    line's parts; returns (its dict, the CLI path's launches, the zoo
    fits' launches)."""
    import torch

    from convnets_tpu_torch.__main__ import main as cli_main
    from convnets_tpu_torch.data.manager import DataMngr
    from convnets_tpu_torch.drivers import process_tune
    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.settings import HyperParamsDistrib, LogUniform, Settings
    from convnets_tpu_torch.train import checkpoint as ckpt

    out, parts = {}, {}
    n_train = CLI_SPLITS[0][1]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = cli_tree(seed)
        parts["tree"] = time.perf_counter() - t0
        common = ["--input-size", "3,32,32", "--num-classes", str(ZOO_CLASSES), "--data-root",
                  root, "--seed", str(seed)]
        rn26 = ["--arch", "resnet", "--kind", "26", "--batch-size", str(CLI_BATCH), *common,
                "--output-dir", os.path.join(tmp, "rn26")]

        # (ii) RN26: fit → load --testing → load --resume → export → serve
        t0 = time.perf_counter()
        cli_rec = new_record()
        sync()
        kernels.reset_launches()
        with recorded_trainers(cli_rec) as rec:
            def run(args, what):
                rc = cli_main(args)
                sync()
                if rc != 0:
                    failures.append(f"cli {what}: exit {rc}")

            run(["fit", *rn26, "--epochs", str(CLI_EPOCHS)], "fit")
            fit_trainer = rec["trainers"][0]
            per_eval, per_step = model_launches(fit_trainer.model)
            fit_loss = list(fit_trainer.epoch_results["train_loss"])
            run(["load", *rn26, "--testing"], "load --testing")
            run(["load", *rn26, "--resume", "--epochs", str(CLI_RESUME_EPOCHS)], "load --resume")
            resumed = rec["trainers"][-1].epoch_results
            art = os.path.join(tmp, "rn26.bin")
            run(["export", *rn26, "--bake-norm", "--out", art], "export")
            rec["capture"] = True
            run(["load", *rn26, "--testing"], "load --testing (exported weights)")
            rec["capture"] = False
        sync()
        rn26_totals = dict(kernels.LAUNCHES)
        say(f"(ii) CLI on the card: fit RN26@32 ({n_train} train PNGs, b{CLI_BATCH}, "
            f"{CLI_EPOCHS} epochs) → load --testing → load --resume --epochs "
            f"{CLI_RESUME_EPOCHS} → export --bake-norm → load --testing: train loss {fit_loss}, "
            f"after the resume {resumed['train_loss']}, valid acc {resumed['valid_score']}")
        check_calls("RN26@32 CLI", rec, per_step, per_eval, failures)
        # the resume goes on from the best epoch's checkpoint, whose history
        # it keeps up to that epoch
        ok_resume = (len(rec["epoch_s"]) == CLI_EPOCHS + CLI_RESUME_EPOCHS
                     and len(resumed["train_loss"]) > CLI_RESUME_EPOCHS
                     and all(np.isfinite(resumed["train_loss"])))
        if not ok_resume:
            failures.append(f"cli resume: {len(rec['epoch_s'])} epochs run, history "
                            f"{resumed['train_loss']}")
        epoch_rates = [n_train / s for s in rec["epoch_s"]]
        say(f"    epoch img/s (fit, then resume) {[round(r, 1) for r in epoch_rates]}; "
            f"Trainer.test img/s {[round(r, 1) for r in rec['test_img_s']]} ({card})")

        # the artifact in a fresh process against the last Trainer.test
        n_test = CLI_SPLITS[2][1]
        batches = -(-n_test // CLI_BATCH)
        timed = rec["eval_io"][-batches:]  # test()'s timed loop, after its warm-up calls
        xs = torch.cat([x[w > 0] for x, _, w in timed]).numpy()
        tested = torch.cat([p[w > 0] for _, p, w in timed]).numpy()
        xfile = os.path.join(tmp, "test_x.npy")
        np.save(xfile, xs)
        child = subprocess.run([sys.executable, "-c", CLI_CHILD, HERE, art, xfile],
                               capture_output=True, text=True, timeout=600)
        served = json.loads(child.stdout.strip().splitlines()[-1]) if child.returncode == 0 \
            else {}
        agree = (float((np.asarray(served.get("argmax", [])) == tested).mean())
                 if len(served.get("argmax", [])) == len(tested) else 0.0)
        ok_art = (child.returncode == 0 and agree >= ARGMAX_MIN and len(tested) == n_test
                  and served["meta"]["normalization_baked"])
        say(f"    the exported artifact ({served.get('meta')}) served the {len(tested)} test "
            f"images in a fresh process (launches {served.get('launches')}): argmax = "
            f"Trainer.test's on {agree:.4f} (min {ARGMAX_MIN}) {'ok' if ok_art else 'FAIL'}")
        if not ok_art:
            failures.append(f"cli artifact: rc {child.returncode}, agreement {agree}, "
                            f"{child.stderr[-2000:]}")
        parts["rn26"] = time.perf_counter() - t0
        out["rn26"] = {"train_loss": resumed["train_loss"], "valid_score": resumed["valid_score"],
                       "epoch_img_s": epoch_rates, "test_img_s": list(rec["test_img_s"]),
                       "artifact_agreement": agree, "launches_per_train_step":
                       launches_summary(per_step)}

        # (ii) each new family through the CLI
        t0 = time.perf_counter()
        zoo_rec = new_record()
        sync()
        kernels.reset_launches()
        out["families"] = {}
        with recorded_trainers(zoo_rec) as rec:
            for arch, kind, image in ZOO:
                if image != 32:
                    continue
                first = (len(rec["train"]), len(rec["eval"]), len(rec["epoch_s"]))
                cli_main(["fit", "--arch", arch, "--kind", kind, "--batch-size",
                          str(CLI_FAMILY_BATCH), "--epochs", str(CLI_FAMILY_EPOCHS), *common,
                          "--output-dir", os.path.join(tmp, arch)])
                sync()
                loss = rec["trainers"][-1].epoch_results["train_loss"]
                rates = [n_train / s for s in rec["epoch_s"][first[2]:]]
                ok = (len(loss) == CLI_FAMILY_EPOCHS and all(np.isfinite(loss))
                      and loss[1] < loss[0])
                say(f"    fit {arch}{kind}@32 b{CLI_FAMILY_BATCH}: train loss {loss} "
                    f"{'ok' if ok else 'FAIL'}; epoch img/s {[round(r, 1) for r in rates]}, "
                    f"Trainer.test {rec['test_img_s'][-1]:.1f} img/s ({card})")
                if not ok:
                    failures.append(f"cli fit {arch}{kind}: train loss {loss}")
                fwd, step = model_launches(rec["trainers"][-1].model)
                sub = {"train": rec["train"][first[0]:], "eval": rec["eval"][first[1]:]}
                check_calls(f"{arch}{kind} CLI", sub, step, fwd, failures)
                out["families"][f"{arch}{kind}"] = {"train_loss": loss, "epoch_img_s": rates,
                                                    "test_img_s": rec["test_img_s"][-1]}
        sync()
        zoo = path_launches(dict(kernels.LAUNCHES), zoo_rec)
        parts["families"] = time.perf_counter() - t0

        # (ii) the command as a user runs it, with and without the card
        t0 = time.perf_counter()
        sub_out = os.path.join(tmp, "subprocess")
        cmd = [sys.executable, "-m", "convnets_tpu_torch", "fit", "--arch", "lenet",
               "--batch-size", str(CLI_FAMILY_BATCH), "--epochs", "1", "--sanity-check", *common,
               "--output-dir", sub_out]
        # both at once: each spends most of its time importing torch
        with_card = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
        without = subprocess.Popen(cmd[:-1] + [sub_out + "_no_card"], cwd=HERE,
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                   env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        try:
            r, no_card = (finished(p, 600) for p in (with_card, without))
        finally:
            for proc in (with_card, without):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        written = [f for f in os.listdir(sub_out) if f.endswith(ckpt.EXT)] \
            if os.path.isdir(sub_out) else []
        ok_sub = r.returncode == 0 and len(written) == 1
        named = "no CUDA device" in no_card.stderr
        ok_no_card = no_card.returncode != 0 and named
        say(f"    python -m convnets_tpu_torch fit --arch lenet --sanity-check: exit "
            f"{r.returncode}, wrote {written} {'ok' if ok_sub else 'FAIL'}; under "
            f"CUDA_VISIBLE_DEVICES= exit {no_card.returncode}, "
            f"{no_card.stderr.strip().splitlines()[-1] if no_card.stderr.strip() else ''!r} "
            f"{'ok' if ok_no_card else 'FAIL'}")
        if not ok_sub:
            failures.append(f"cli subprocess fit: exit {r.returncode}, {r.stderr[-2000:]}")
        if not ok_no_card:
            failures.append(f"cli without a card: exit {no_card.returncode}, "
                            f"{no_card.stderr[-2000:]}")
        out["subprocess"] = {"exit": r.returncode, "checkpoints": written,
                             "no_card_exit": no_card.returncode}
        parts["subprocess"] = time.perf_counter() - t0

        # (iii) the tuner
        t0 = time.perf_counter()
        distrib = HyperParamsDistrib(
            batch_size=[CLI_FAMILY_BATCH], batch_norm=[False, True], epochs=[1],
            learning_rate=LogUniform(1e-4, 1e-2), lr_factor=[0.1], lr_patience=[5],
            weight_decay=[1e-4], dropout_rate=[0.0], loss_optim=[False], data_augment=[False],
            data_norm=[True], early_stop=[False], es_patience=[10], grad_clip_norm=[False],
            gc_max_norm=[1.0], grad_clip_value=[False], gc_value=[1.0], init_params=[True])
        tune_dir = os.path.join(tmp, "tune")
        setting = Settings(kind="base", input_size=(3, 32, 32), num_classes=ZOO_CLASSES,
                           batch_size=CLI_FAMILY_BATCH, epochs=1, seed=TUNE_SEED,
                           output_dir=tune_dir, distrib=distrib)
        sync()
        kernels.reset_launches()
        first = len(cli_rec["trainers"])
        with recorded_trainers(cli_rec):
            winner, results = process_tune("mynetwork", setting, TUNE_SAMPLES, data_root=root)
        sync()
        cli = path_launches({k: v + rn26_totals[k] for k, v in kernels.LAUNCHES.items()},
                            cli_rec)
        tune_calls = cli_rec["train"][-TUNE_SAMPLES * (n_train // CLI_FAMILY_BATCH):]
        bn = [c for c in tune_calls if c["conv2d_stats"]]
        nobn = [c for c in tune_calls if not c["conv2d_stats"]]
        # per train step of the sampled models, with BN and without (their
        # settings are the tuner's one object, which each sample rewrites)
        want = {bool(w["conv2d_stats"]): w for w in
                (model_launches(t.model)[1] for t in cli_rec["trainers"][first:])}
        step, want_nobn = want.get(True), want.get(False)
        ok_steps = (bn and nobn and all(c == step for c in bn)
                    and all(c == want_nobn for c in nobn))
        tuned = [f for f in os.listdir(tune_dir) if f.endswith(ckpt.SUFFIX_TUNED + ckpt.EXT)]
        meta = ckpt.load_checkpoint(os.path.join(tune_dir, tuned[0]))[1] if len(tuned) == 1 \
            else {}
        valid = DataMngr(winner.setting, root=root, device=DEVICE).load_valid()
        rescored = winner.evaluate(valid, info=False)
        best = max(results["scores"])
        ok_tune = (ok_steps and len(results["scores"]) == TUNE_SAMPLES
                   and meta.get("extra", {}).get("tuning_results", {}).get("scores")
                   == results["scores"] and rescored == best)
        say(f"(iii) process_tune mynetwork, {TUNE_SAMPLES} samples (seed {TUNE_SEED}): "
            f"{[(s['batch_norm'], round(s['learning_rate'], 5)) for s in results['samples']]} "
            f"(batch_norm, lr) → valid scores {results['scores']}, best {best}; train steps "
            f"with BN {len(bn)} each {launches_summary(step)}, without {len(nobn)} each "
            f"{launches_summary(want_nobn)}; tuned checkpoint {tuned} with tuning_results; the "
            f"reloaded winner scores {rescored} {'ok' if ok_tune else 'FAIL'}")
        if not ok_tune:
            failures.append(f"tuner: steps ok {bool(ok_steps)} ({len(bn)} / {len(nobn)}), "
                            f"files {tuned}, rescored {rescored} vs {best}")
        out["tuner"] = {"samples": results["samples"], "scores": results["scores"],
                        "rescored": rescored, "bn_steps": len(bn), "nobn_steps": len(nobn)}
        parts["tuner"] = time.perf_counter() - t0
    out["seconds"] = parts
    return out, cli, zoo


# phase 13: the replayed-graph epoch (train/graph.py StepGraph) against the
# per-step loop. (i)-(iii): RN26@32 with phase 11's settings on a train
# split that is not a multiple of the batch (its last batch: 164 real rows,
# 92 replaying index 0 at weight 0); (iv): RN50@224 with bench.py's
# settings, chunked (ShardRotationLoader, 3 chunks of 6 batches, the last
# one's 2 batches without an example not run, the third chunk refilling a
# pinned slot) against resident
GRAPH_TRAIN = 8100
GRAPH_EPOCHS = 2
CHUNK_IMAGES, CHUNK_BYTES, CHUNK_BATCH, CHUNK_EPOCHS = 4096, 256 << 20, 256, 2


def leaf_gaps(a: dict, b: dict) -> dict:
    """max |a − b| / max |b| per tensor of two state dicts (on the host)."""
    return {k: float((a[k].double() - b[k].double()).abs().max()
                     / max(float(b[k].double().abs().max()), 1e-30)) for k in b}


def hold_to_control(label, got, want, control, control_what, failures):
    """The bar of phase 13: `got` (dict of leaves and scalars) equals `want`
    bit for bit where `control` (`want`'s route run again) equals it bit
    for bit; otherwise each leaf within CONTROL_FACTOR × the control's own
    gap on it. Returns (bit-identical, worst gap, worst control gap)."""
    gaps, cgaps = leaf_gaps(got, want), leaf_gaps(control, want)
    exact = all(torch_equal(got[k], want[k]) for k in want)
    control_exact = all(torch_equal(control[k], want[k]) for k in want)
    ok = exact if control_exact else all(gaps[k] <= CONTROL_FACTOR * cgaps[k] for k in want)
    worst, cworst = max(gaps.values()), max(cgaps.values())
    say(f"    {label}: bit-identical {exact}; the control ({control_what}) "
        f"bit-identical {control_exact}; worst leaf gap {worst:.3e} (control {cworst:.3e}) "
        f"over {len(want)} leaves {'ok' if ok else 'FAIL'}")
    if not ok:
        bad = [k for k in want if gaps[k] > CONTROL_FACTOR * cgaps[k]][:4]
        failures.append(f"{label}: leaves {bad} off (gap {worst:.3e}, control {cworst:.3e})")
    return exact, worst, cworst


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


def run_leaves(trainer, results) -> dict:
    """The trainer's parameters and buffers on the host, and each epoch's
    (loss, score) in `results` as 0-d fp64 tensors."""
    import torch

    out = {k: t.detach().cpu().clone() for k, t in trainer.model.state_dict().items()}
    for e, (loss, score) in enumerate(results):
        out[f"epoch{e}/loss"] = torch.tensor(loss, dtype=torch.float64)
        out[f"epoch{e}/score"] = torch.tensor(score, dtype=torch.float64)
    return out


def counted_run(fn, path: dict):
    """Run fn with the launch counters at 0 just before it and add what it
    launched into `path` just after it."""
    from convnets_tpu_torch.ops import kernels

    sync()
    kernels.reset_launches()
    out = fn()
    sync()
    for k, v in kernels.LAUNCHES.items():
        path[k] = path.get(k, 0) + v
    return out


def graphs_of(trainer):
    from convnets_tpu_torch.train.graph import StepGraph

    return [g for g in trainer._epoch_fns.values() if isinstance(g, StepGraph)]


def graph_rn26_check(seed, out_dir, card, failures):
    """Phase 13 (i)-(iii). Returns (results, the graphed trainer's launches)."""
    import torch

    from convnets_tpu_torch.data import ArrayDataset, DeviceCacheLoader
    from convnets_tpu_torch.data.augment import MixupDraws, mixup_apply
    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.train import Trainer
    from convnets_tpu_torch.train.graph import WARMUP_STEPS

    res, path = {}, {}
    train_ds, valid_ds = trainer_data(seed)
    train_ds = ArrayDataset(train_ds.images[:GRAPH_TRAIN], train_ds.labels[:GRAPH_TRAIN])
    setting = trainer_setting(seed, out_dir, data_augment=True, augment_affine=True,
                              data_norm=True, cutout=AUG_CUTOUT, mixup=AUG_MIXUP)
    routes = ("graphed", "per_step", "control")
    trainers, loaders, calls = {}, {}, new_record()
    first = None
    for name in routes:
        model = build_model("resnet", setting, device=DEVICE)
        if first is None:
            first = model.state_dict()
        model.load_state_dict(first)
        trainers[name] = Trainer(model)
        trainers[name]._new_state()
        pair = [DeviceCacheLoader(ds, TRAINER_BATCH, shuffle=shuffle, seed=seed, device=DEVICE)
                for ds, shuffle in ((train_ds, True), (valid_ds, False))]
        for loader in pair:
            loader.augment, loader.normalize = loader is pair[0], True
            loader.scan_epochs = name == "graphed"
        loaders[name] = pair
    count_calls(trainers["graphed"], calls)
    results = {name: [] for name in routes}
    seconds = {name: [] for name in routes}
    for e in range(GRAPH_EPOCHS):
        for name in routes if e % 2 == 0 else routes[::-1]:  # in turns
            def epoch(name=name, e=e):
                return trainers[name]._run_train_epoch(loaders[name][0], e)
            sync()
            t0 = time.perf_counter()
            out = counted_run(epoch, path) if name == "graphed" else epoch()
            seconds[name].append(time.perf_counter() - t0)
            results[name].append(out)
    evals = {}
    for name in routes:
        def run_eval(name=name):
            return trainers[name]._run_eval_epoch(loaders[name][1], collect_preds=True)
        evals[name] = counted_run(run_eval, path) if name == "graphed" else run_eval()
    leaves = {name: run_leaves(trainers[name], results[name]) for name in routes}
    for name in routes:
        leaves[name]["eval/loss"] = torch.tensor(evals[name][0], dtype=torch.float64)
        leaves[name]["eval/preds"] = torch.from_numpy(np.asarray(evals[name][3]))
    steps = len(loaders["graphed"][0])
    say(f"(i) RN26@32 bf16 b{TRAINER_BATCH}, {GRAPH_TRAIN} train images ({steps} steps, "
        f"the last one padded) with phase 11's settings, {GRAPH_EPOCHS} epochs per route "
        f"from the same weights, in turns: train (loss, score) graphed {results['graphed']}, "
        f"per-step {results['per_step']}, control {results['control']}; eval loss "
        f"{[evals[n][0] for n in routes]}")
    exact, worst, cworst = hold_to_control(
        "(i) graphed vs per-step: every parameter and BN buffer, each epoch's loss and score, "
        "evaluate's loss and predictions", leaves["graphed"], leaves["per_step"],
        leaves["control"], "the per-step route twice", failures)
    res.update(results=results, eval_loss={n: evals[n][0] for n in routes},
               bit_identical=exact, worst_gap=worst, control_gap=cworst,
               control_bit_identical=cworst == 0.0)

    # (ii) launches per step and per eval batch, from the per-replay tally
    model = trainers["graphed"].model
    n = conv_count(model)
    per_step = launches_of({"conv2d_stats": n, "conv2d_stats_reduce": n, "max_pool2d": 1,
                            "pool2d_backward": 1, **bn_sites(n)})
    per_eval = launches_of({"conv2d_fused": n, "max_pool2d": 1})
    graphs = graphs_of(trainers["graphed"])
    replays = {g.kind: launches_summary(g.per_replay[0]) for g in graphs if g.per_replay}
    steps_train = len(loaders["graphed"][0]) * GRAPH_EPOCHS
    ok_calls = (len(calls["train"]) == steps_train
                and len(calls["eval"]) == len(loaders["graphed"][1])
                and all(c == per_step for c in calls["train"])
                and all(c == per_eval for c in calls["eval"])
                and set(replays) == {"train", "eval"})
    say(f"(ii) launches: {len(calls['train'])} graphed train steps each "
        f"{launches_summary(per_step)}, {len(calls['eval'])} eval batches each "
        f"{launches_summary(per_eval)} (per replay, counted at the capture: {replays}) "
        f"{'ok' if ok_calls else 'FAIL'}")
    if not ok_calls:
        failures.append(f"graphed epoch launches per step off: "
                        f"{[c for c in calls['train'] if c != per_step][:1]} "
                        f"{[c for c in calls['eval'] if c != per_eval][:1]} {replays}")
    # mixup's λ: a CPU scalar (the eager step before) and the device scalar
    # the captured step reads give the same bits
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.rand((TRAINER_BATCH, 32, 32, 3), generator=g, device=DEVICE).bfloat16()
    perm = torch.randperm(TRAINER_BATCH, generator=g, device=DEVICE)
    lam = 0.2718281828
    dev_lam = torch.zeros((), device=DEVICE).fill_(lam)
    ok_lam = torch.equal(mixup_apply(x, MixupDraws(lam, perm)),
                         mixup_apply(x, MixupDraws(dev_lam, perm)))
    say(f"(ii) mixup λ as a CPU scalar vs as the device scalar, bf16 b{TRAINER_BATCH}: "
        f"bit-identical {ok_lam} {'ok' if ok_lam else 'FAIL'}")
    if not ok_lam:
        failures.append("mixup λ: the device scalar changes the bits")

    # (ii)-(iii) one more graphed epoch under the profiler: its only
    # host-to-device copies are the index and weight matrices, before the
    # replays; device time per step and the idle share
    sync()
    prof, host, copies, memcpys = profiled_epoch(lambda: counted_run(
        lambda: Trainer._run_train_epoch(trainers["graphed"], loaders["graphed"][0],
                                         GRAPH_EPOCHS), path))
    device, ours, _ = device_split(prof, OUR_KERNELS)
    matrix_bytes = steps * TRAINER_BATCH * 4
    ok_copies = copies_ok(copies, memcpys, matrix_bytes) and device > 0
    idle = 1.0 - device / 1e6 / host
    # the idle share of the timed (unprofiled) graphed epoch 1: the profiled
    # epoch's device time per step against its host seconds per step
    timed_idle = 1.0 - (device / 1e6 / steps) / (seconds["graphed"][-1] / steps)
    say(f"(ii) profiled graphed epoch ({steps} replays): "
        f"{copies_text(copies, memcpys, matrix_bytes)} {'ok' if ok_copies else 'FAIL'}")
    if not ok_copies:
        failures.append(f"graphed epoch H2D copies {copies[:8]} ({len(copies)}), memcpy calls "
                        f"{memcpys}")
    rates = {name: [GRAPH_TRAIN / t for t in seconds[name]] for name in routes}
    capture = {g.kind: g.capture_s for g in graphs}
    say(f"(iii) {card}: train epoch img/s, graphed {[round(r, 1) for r in rates['graphed']]}, "
        f"per-step {[round(r, 1) for r in rates['per_step']]}, control "
        f"{[round(r, 1) for r in rates['control']]} (epoch 0 of the graphed route holds its "
        f"{WARMUP_STEPS} eager steps and the capture); profiled graphed epoch: device "
        f"{device / 1e3 / steps:.3f} ms per step, host {1e3 * host / steps:.3f} ms per step "
        f"under the profiler, idle share {idle:.4f} there and {timed_idle:.4f} against the "
        f"timed epoch {GRAPH_EPOCHS - 1} ({1e3 * seconds['graphed'][-1] / steps:.3f} ms per "
        f"step), the port's kernels {ours / 1e3 / steps:.3f} ms per step; "
        f"capture {', '.join(f'{k} {v} s' for k, v in capture.items())}")
    res.update(img_s=rates, launches_per_train_step=launches_summary(per_step),
               per_replay=replays, h2d_copies=copies, memcpy_calls=memcpys,
               profiled_epoch={"host_ms": 1e3 * host, "device_ms": device / 1e3,
                               "device_ms_per_step": device / 1e3 / steps, "idle_share": idle,
                               "timed_epoch_idle_share": timed_idle, "kernels_ms": ours / 1e3},
               capture_s=capture)
    return res, path


def graph_chunked_check(seed, out_dir, card, failures):
    """Phase 13 (iv): RN50@224 bf16 b256 (bench.py:39-43's settings: Adam,
    weight decay 1e-4, dropout 0.5), CHUNK_EPOCHS epochs over CHUNK_IMAGES
    uint8 images resident (DeviceCacheLoader, graphed), chunked
    (ShardRotationLoader, CHUNK_BYTES chunks) and resident again (the
    control), from the same seeded weights and permutations. Returns
    (results, the chunked epochs' launches)."""
    import gc

    import torch

    from convnets_tpu_torch.data import ArrayDataset, DeviceCacheLoader, ShardRotationLoader
    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 40)
    ds = ArrayDataset(rng.integers(0, 256, (CHUNK_IMAGES, IMAGE, IMAGE, 3), dtype=np.uint8),
                      rng.integers(0, 1000, CHUNK_IMAGES).astype(np.int32))
    made_s = time.perf_counter() - t0
    setting = model_setting("resnet", seed, True, batch_size=CHUNK_BATCH, data_augment=False,
                            data_norm=False, output_dir=out_dir)
    path, runs, leaves = {}, {}, {}
    per_step = launches_of({"conv2d_stats": 53, "conv2d_stats_reduce": 53, "max_pool2d": 1,
                            "pool2d_backward": 1, **bn_sites(53)})
    for name in ("resident", "chunked", "control"):
        trainer = Trainer(build_model("resnet", setting, device=DEVICE))
        trainer._new_state()
        if name == "chunked":
            loader = ShardRotationLoader(ds, CHUNK_BATCH, shuffle=True, seed=seed,
                                         chunk_bytes=CHUNK_BYTES, device=DEVICE)
            plan = loader._plan()
        else:
            loader = DeviceCacheLoader(ds, CHUNK_BATCH, shuffle=True, seed=seed, device=DEVICE)
        calls = new_record()
        count_calls(trainer, calls)
        sync()
        torch.cuda.reset_peak_memory_stats()
        outs, rates = [], []
        for e in range(CHUNK_EPOCHS):
            def epoch(e=e):
                return trainer._run_train_epoch(loader, e)
            t1 = time.perf_counter()
            outs.append(counted_run(epoch, path) if name == "chunked" else epoch())
            rates.append(CHUNK_IMAGES / (time.perf_counter() - t1))
        peak = torch.cuda.max_memory_allocated()
        graph = graphs_of(trainer)[0]
        runs[name] = {"loss_score": outs, "img_s": rates, "peak_bytes": peak,
                      "capture_s": graph.capture_s, "steps": len(calls["train"]),
                      "launches_ok": all(c == per_step for c in calls["train"])}
        leaves[name] = run_leaves(trainer, outs)
        del trainer, loader, graph, calls
        gc.collect()
        torch.cuda.empty_cache()
    steps = -(-CHUNK_IMAGES // CHUNK_BATCH)
    per_chunk = CHUNK_BYTES // (CHUNK_BATCH * IMAGE * IMAGE * 3)  # 6 at 224²
    ok_plan = plan == (steps, per_chunk, -(-steps // per_chunk)) and all(
        r["steps"] == steps * CHUNK_EPOCHS and r["launches_ok"] for r in runs.values())
    say(f"(iv) RN50@224 bf16 b{CHUNK_BATCH}, {CHUNK_IMAGES} uint8 images "
        f"({CHUNK_IMAGES * IMAGE * IMAGE * 3 / 1e9:.3f} GB, made in {made_s:.1f} s), "
        f"{CHUNK_EPOCHS} epochs each (the first holds the eager steps and the capture): "
        f"chunked plan (batches, per chunk, chunks) {plan}, {runs['chunked']['steps']} "
        f"steps each {launches_summary(per_step)} {'ok' if ok_plan else 'FAIL'}")
    for name, r in runs.items():
        say(f"    {name}: (loss, score) per epoch {r['loss_score']}, img/s per epoch "
            f"{[round(v, 1) for v in r['img_s']]} ({card}), peak "
            f"device memory {r['peak_bytes'] / 2 ** 30:.3f} GiB, capture {r['capture_s']} s")
    if not ok_plan:
        failures.append(f"chunked epoch: plan {plan}, runs {runs}")
    exact, worst, cworst = hold_to_control(
        "(iv) chunked vs resident: every parameter and BN buffer, each epoch's loss and score",
        leaves["chunked"], leaves["resident"], leaves["control"], "the resident route twice",
        failures)
    return {"runs": runs, "plan": plan, "bit_identical": exact, "worst_gap": worst,
            "control_gap": cworst}, path


def phase_graph(seed, card, failures):
    """Phase 13: the replayed-graph epoch. Prints the graph JSON line;
    returns the launches of the graphed RN26 epochs and of the chunked
    RN50 epoch."""
    out, parts = {"card": card}, {}
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        out["rn26"], graphed = graph_rn26_check(seed, out_dir, card, failures)
        parts["i_iii"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["rn50_chunked"], chunked = graph_chunked_check(seed, out_dir, card, failures)
        parts["iv"] = time.perf_counter() - t0
    out["seconds"] = parts
    say(json.dumps({"graph": out}))
    return path_entries(graphed), path_entries(chunked)


def path_entries(totals):
    """A train path's launches per kernels-line entry (the kernels it
    launched): each kernel's count, conv_bn_relu_train by its conv2d_stats
    launches, pool2d_train by the pool2d_backward launches (one per train
    step's max pool)."""
    out = {k: totals.get(k, 0) for k in ("conv2d_fused", "max_pool2d", "conv2d_stats",
                                          "conv2d_stats_reduce", "pool2d_backward",
                                          "bn_act_forward")}
    out["conv_bn_relu_train"] = totals.get("conv2d_stats", 0)
    out["bn_act_backward"] = totals.get("bn_act_backward_apply", 0)
    out["pool2d_train"] = totals.get("pool2d_backward", 0)
    return {k: v for k, v in out.items() if v}


# phase 14: the rest of the zoo and the widened conv envelopes it needs.
# (ii): the reference's CINIC configurations (3x32x32, 10 classes, full
# width and depth) and AlexNet's ImageNet geometry
ZOO2 = (("alexnet", "cifar", 32), ("senet", "26", 32), ("se_resnet", "26", 32),
        ("sknet", "26", 32), ("sk_resnet", "26", 32), ("shufflenet_v1", "g4", 32),
        ("alexnet", "imagenet", 224))
ZOO2_NOBN = (("sk_resnet", "26"), ("shufflenet_v1", "g4"))  # (ii): rows 7 and 8 at NOBN_BATCH
ZOO2_CLI = (("se_resnet", "26"), ("sk_resnet", "26"), ("shufflenet_v1", "g4"))  # (iii)
ZOO2_EXPORT = ("sk_resnet", "shufflenet_v1")  # (iii): exported, served by a fresh process
ZOO2_CLI_BATCH = 256
# (i): the dilated grouped shapes of these (arch, kind, image) at their
# batches, every grouped shape of ShuffleNet's kinds at 32² and 224² (wide:
# Cin/G > 32, narrow: the rest), AlexNet's stem at 224² and one dilated
# dense shape (N, H, W, Cin, Cout, k, stride, pad, dilation)
ZOO2_DILATED = (("sknet", "26", 32), ("sk_resnet", "26", 32))
ZOO2_DILATED_BATCHES = ((64, "float32"), (256, "bfloat16"))
ZOO2_DILATED_224 = ("sknet", "50", 224)
ZOO2_SHUFFLE_KINDS = ("g2", "g3", "g4", "g8")
ZOO2_STEM_BATCHES = (8, 256)
ZOO2_DENSE_DILATED = (8, 28, 28, 64, 64, 3, 1, 2, 2)
# the timed b256 bf16 calls: the kernels' ms, cuDNN's, the bound and, for a
# grouped call, the CUDA-core loop's ms on the same inputs (route "simt")
ZOO2_KEYS = ("zoo2_ms_b256", "zoo2_library_ms_b256", "zoo2_bound_ms_b256", "zoo2_simt_ms_b256")
# the same at 224² (rows 1g and 5g: SKNet-50's dilated grouped 3x3s and
# ShuffleNet g2-g8's grouped 1x1s at b256 bf16)
ZOO2_224_KEYS = ("zoo2_224_ms_b256", "zoo2_224_library_ms_b256", "zoo2_224_bound_ms_b256",
                 "zoo2_224_simt_ms_b256")
# rows 1g and 5g: their launches per route on phase 14's path and per
# ShuffleNet-g4@32 forward and step (zoo_family)
ROUTE_KEYS = ("zoo2_route_launches", "shufflenet_g4_route_launches")
# device kernels whose name marks a library convolution (cuDNN's and
# CUTLASS's forward, data-gradient and weight-gradient kernels); the port's
# own (OUR_KERNELS) are left out
LIBRARY_CONV_MARKS = ("cudnn", "fprop", "dgrad", "wgrad", "implicit", "conv", "winograd")


def zoo2_shapes(arch, kind, image, want):
    """{(H, W, Cin, Cout, k, stride, pad, dilation, groups)} of the grouped
    convs of the model that `want` picks, "dilated" (dilation > 1), "wide"
    (Cin/G > 32) or "grouped" (all), read off its modules (built on the
    CPU: only its shapes are read)."""
    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.settings import Settings

    model = build_model(arch, Settings(kind=kind, input_size=(3, image, image),
                                       num_classes=ZOO_CLASSES), device="cpu")
    return {(h, w, cin, cout, k, s, p, d, g)
            for layer, h, w, cin, cout, k, s, p, _, g, d in model_layers(model, with_dilation=True)
            if layer.endswith("gconv") and ((want == "dilated" and d > 1) or want == "grouped"
                                            or (want == "wide" and cin // g > 32))}


def zoo2_kernel_fns(groups):
    """(fused, fused plain, stats, stats plain, leading arguments) of the
    kernels that take a conv of `groups`: the dense or the grouped ones."""
    from convnets_tpu_torch.ops import kernels

    if groups == 1:
        return (kernels.conv2d_fused, kernels.conv2d_fused_plain, kernels.conv2d_stats,
                kernels.conv2d_stats_plain, ())
    return (kernels.grouped_conv2d_fused, kernels.grouped_conv2d_fused_plain,
            kernels.grouped_conv2d_stats, kernels.grouped_conv2d_stats_plain, (groups,))


def zoo2_route(dtype, n, h, w, cin, cout, k, s, p, d, groups):
    """(the route the wrappers' plan gives the call, the route it must be:
    bf16 on the tensor cores, dense always ("wgmma"), grouped on the
    grouped mode ("wgmma") where Cin/G = Cout/G in {4, 8, 16, 32} with Cin
    % 64 == 0, dilated or not, on csrc/grouped_wgmma.cu ("wgmma_wide") at
    every other Cin/G but 2; Cin/G = 2 and fp32 on the CUDA cores)."""
    import torch

    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.ops.kernels.conv import GROUPED_WGMMA_CG

    if groups == 1:
        m = n * conv_out_size(h, k, s, p, d) * conv_out_size(w, k, s, p, d)
        got = kernels.conv_plan(dtype, m, cin, cout).route
        return got, "wgmma" if dtype == torch.bfloat16 else "simt"
    got = kernels.grouped_plan(dtype, cin, cout, groups).route
    cg = cin // groups
    if dtype != torch.bfloat16 or cg == 2:
        return got, "simt"
    return got, ("wgmma" if cin == cout and cin % 64 == 0 and cg in GROUPED_WGMMA_CG
                 else "wgmma_wide")


def zoo2_conv_check(label, n, shape, dtype, g, summary, failures, times=False):
    """One new shape against its plain versions on the card: conv2d_fused /
    grouped_conv2d_fused with and without scale/shift/ReLU, and
    conv2d_stats / grouped_conv2d_stats (y, and Σy, Σy² against the sums of
    the kernel's own stored y), with phase 2/4/8's bars, on the route the
    plan gives it. times: also the bf16 device ms of both kernels on that
    route, cuDNN's bf16 F.conv2d of the same stride, dilation and groups,
    the bound and, for a grouped call, both kernels on the CUDA-core loop
    (route "simt", the same inputs), added to the rows' zoo2_*_b256
    (ZOO2_KEYS), or to the keys `times` names. The three checked calls
    must each be counted once on the plan's route (ROUTE_LAUNCHES; dense:
    LAUNCHES). Returns the record."""
    import torch
    import torch.nn.functional as F

    from convnets_tpu_torch.ops import kernels

    h, w, cin, cout, k, s, p, d, groups = shape
    dname = dname_of(dtype)
    atol, rtol = CONV_TOL[dname]
    cg = cin // groups
    x = torch.randn(n, h, w, cin, device=DEVICE, generator=g).to(dtype)
    wt = (torch.randn(k, k, cg, cout, device=DEVICE, generator=g) / np.sqrt(k * k * cg)).to(dtype)
    scale = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
    shift = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
    fused, fused_plain, stats, stats_plain, lead = zoo2_kernel_fns(groups)
    route, want = zoo2_route(dtype, n, h, w, cin, cout, k, s, p, d, groups)
    errs, ok = [], route == want
    kernels.reset_launches()
    for epi in (None, (scale, shift)):
        kw = dict(stride=s, padding=p, dilation=d, relu=epi is not None)
        got = fused(x, wt, *lead, *(epi or ()), **kw)
        ref = fused_plain(x, wt, *lead, *(epi or ()), **kw)
        sync()
        errs.append(float((got.float() - ref.float()).abs().max()))
        ok = ok and within(got, ref, atol, rtol) and bool(torch.isfinite(got).all())
        del got, ref
    kw = dict(stride=s, padding=p, dilation=d)
    s_ok, y_err, e1, e2 = stats_check(stats(x, wt, *lead, **kw), stats_plain(x, wt, *lead, **kw),
                                      dname, own=True)
    # the three kernel calls, each counted on the plan's route
    if groups > 1:
        counted = {name: dict(kernels.ROUTE_LAUNCHES[name]) for name in GROUPED_ROUTED}
        counted_want = {name: {r: int(r == route) * (2 if name.endswith("fused") else 1)
                               for r in ("wgmma", "wgmma_wide", "simt")}
                        for name in GROUPED_ROUTED}
    else:
        counted = {k: kernels.LAUNCHES[k] for k in ("conv2d_fused", "conv2d_stats")}
        counted_want = {"conv2d_fused": 2, "conv2d_stats": 1}
    ok = ok and counted == counted_want
    rec = {"what": label, "n": n, "shape": list(shape), "dtype": dname, "route": route,
           "fused_err": errs, "stats_y_err": y_err, "sum_rel": e1, "sumsq_rel": e2,
           "ok": bool(ok and s_ok)}
    fname = "conv2d_fused" if groups == 1 else "grouped_conv2d_fused"
    sname = "conv2d_stats" if groups == 1 else "grouped_conv2d_stats"
    entry(summary, fname)["err"] = max(entry(summary, fname)["err"], *errs)
    entry(summary, sname)["err"] = max(entry(summary, sname)["err"], y_err)
    text = ""
    if times:
        f_ms = time_ms(lambda: fused(x, wt, *lead, scale, shift, relu=True, **kw), REPS)
        s_ms = time_ms(lambda: stats(x, wt, *lead, **kw), REPS)
        xc, wc = nchw(x), oihw(wt)
        c_ms = time_ms(lambda: F.conv2d(xc, wc, stride=s, padding=p, dilation=d, groups=groups),
                       REPS)
        flops, nbytes = conv_work(n, h, w, cin, cout, k, s, p, groups, dilation=d)
        bound = 1e3 * max(flops / PEAK_BF16, (nbytes + 8 * cout) / HBM_BPS)
        simt = ((f_ms, s_ms) if groups == 1 or route == "simt" else
                grouped_route_ms(x, wt, groups, scale, shift, s, p, True, "simt", dilation=d))
        if groups > 1 and route == "simt":  # the plan's CUDA-core shapes on the tensor cores too
            rec["wide_fused_ms"], rec["wide_stats_ms"] = grouped_route_ms(
                x, wt, groups, scale, shift, s, p, True, "wgmma_wide", dilation=d)
        for name, ms, loop in ((fname, f_ms, simt[0]), (sname, s_ms, simt[1])):
            row = entry(summary, name)
            for key, v in zip(ZOO2_KEYS if times is True else times,
                              (ms, c_ms, bound) + ((loop,) if groups > 1 else ())):
                row[key] = row.get(key, 0.0) + v
        rec.update(fused_ms=f_ms, stats_ms=s_ms, cudnn_ms=c_ms, bound_ms=bound,
                   tflops=flops / f_ms / 1e9)
        text = (f" | {f_ms:.4f} {s_ms:.4f} {c_ms:.4f} {bound:.4f} "
                f"({flops / f_ms / 1e9:.1f} TFLOP/s)")
        if groups > 1:
            rec.update(simt_fused_ms=simt[0], simt_stats_ms=simt[1])
            text += f" | simt {simt[0]:.4f} {simt[1]:.4f}"
        if "wide_fused_ms" in rec:
            text += f" | wgmma_wide {rec['wide_fused_ms']:.4f} {rec['wide_stats_ms']:.4f}"
    say(f"  {label} | {n} {' '.join(map(str, shape))} | {dname} {route} (want {want}) | "
        f"{errs[0]:.3e} / {errs[1]:.3e} ({atol:g}+{rtol:g}|ref|) | {y_err:.3e}, {e1:.2e}, "
        f"{e2:.2e} ({STATS_TOL[dname]:g}, own y) {'ok' if rec['ok'] else 'FAIL'}{text}")
    if not rec["ok"]:
        failures.append(f"zoo2 {label} {n}x{shape} {dname} {route} (want {want}): fused {errs}, "
                        f"stats y {y_err:.3e} Σ {e1:.2e} Σ² {e2:.2e}, launches {counted}")
    del x, wt
    return rec


def zoo2_kernels(summary, failures):
    """Phase 14 (i): the widened envelopes against their plain versions,
    fp32 (TF32 off) and bf16: every distinct dilated grouped shape of
    SKNet-26 and SK-ResNet-26 at 32² (b64 fp32, b256 bf16, timed), and
    SK-ResNet-26's undilated Cin/G = 2 ones alike (timed on both the
    CUDA-core loop of their plan and the tensor-core route), and of
    SKNet-50 at 224² (b8; b256 bf16, timed); every distinct grouped shape
    of ShuffleNet-v1 g2, g3, g4, g8 at 32² and 224², wide (Cin/G > 32) and
    narrow (b8 both dtypes; b256 bf16, timed, the CUDA-core loop beside);
    AlexNet's 11x11/4 stem at 224² (b8, b256, timed); one dilated dense
    shape (b8, and timed at b256); then each train function at one new
    shape, forward and gradients. Returns its records."""
    import torch

    from convnets_tpu_torch.ops import kernels

    g = torch.Generator(device=DEVICE).manual_seed(14)
    f32, bf16 = torch.float32, torch.bfloat16
    dtypes = {"float32": f32, "bfloat16": bf16}
    cases = []  # (label, n, shape, dtype, timed)
    dilated = {}
    for arch, kind, image in ZOO2_DILATED:
        for shape in zoo2_shapes(arch, kind, image, "dilated"):
            dilated.setdefault(shape, []).append(f"{arch}{kind}")
    for shape, where in sorted(dilated.items()):
        for n, dname in ZOO2_DILATED_BATCHES:
            cases.append((f"dilated {'/'.join(where)}@32", n, shape, dtypes[dname],
                          dname == "bfloat16"))
    # SK-ResNet's Cin/G = 2 paths that are not dilated (the dilated ones are
    # above): the plan keeps Cin/G = 2 on the CUDA-core loop, timed beside
    # the tensor-core route
    for arch, kind, image in ZOO2_DILATED:
        for shape in sorted(zoo2_shapes(arch, kind, image, "grouped")):
            if shape[7] == 1 and shape[2] // shape[8] == 2:
                cases += [(f"cg2 {arch}{kind}@{image}", n, shape, dtypes[dname],
                           dname == "bfloat16") for n, dname in ZOO2_DILATED_BATCHES]
    arch, kind, image = ZOO2_DILATED_224
    for shape in sorted(zoo2_shapes(arch, kind, image, "dilated")):
        cases += [(f"dilated {arch}{kind}@{image}", KERNEL_BATCH, shape, dt, False)
                  for dt in (f32, bf16)]
        cases.append((f"dilated {arch}{kind}@{image}", B256, shape, bf16, ZOO2_224_KEYS))
    shuffle = {}
    for gk in ZOO2_SHUFFLE_KINDS:
        for image in (32, IMAGE):
            for shape in zoo2_shapes("shufflenet_v1", gk, image, "grouped"):
                shuffle.setdefault((image, shape), []).append(gk)
    for (image, shape), where in sorted(shuffle.items()):
        label = (f"{'wide' if shape[2] // shape[8] > 32 else 'narrow'} {'/'.join(where)}"
                 f"@{image}")
        for dt in (f32, bf16):
            cases.append((label, KERNEL_BATCH, shape, dt, False))
        cases.append((label, B256, shape, bf16, True if image == 32 else ZOO2_224_KEYS))
    stem = (IMAGE, IMAGE, 3, 64, 11, 4, 2, 1, 1)
    for n in ZOO2_STEM_BATCHES:
        cases += [("alexnet stem 11x11/4", n, stem, dt, n == B256 and dt == bf16)
                  for dt in (f32, bf16)]
    n, *dense = ZOO2_DENSE_DILATED
    dense_shape = (*dense, 1)
    cases += [("dilated dense", n, dense_shape, dt, False) for dt in (f32, bf16)]
    cases.append(("dilated dense", B256, dense_shape, bf16, True))
    say(f"(i) the widened envelopes, {len(cases)} calls: what | N H W Cin Cout k s p d G | dtype "
        f"route | fused y err relu=0 / 1 (tol) | stats y err, Σ rel, Σ² rel (tol, own y) | at "
        f"b{B256} bf16: fused ms, stats ms, cuDNN ms, bound ms | grouped: the CUDA-core loop's "
        f"fused ms, stats ms")
    records = [zoo2_conv_check(label, n, shape, dt, g, summary, failures, timed)
               for label, n, shape, dt, timed in cases]
    kinds = {}
    for r in records:
        if "fused_ms" in r:
            what = r["what"]
            kinds.setdefault(what.split(" ")[0] + "@" + what.rsplit("@", 1)[1] if "@" in what
                             else what, []).append(r)
    for kind, timed in kinds.items():
        loop = ""
        if all("wide_fused_ms" in r for r in timed):
            loop = (f", the tensor-core route: fused {sum(r['wide_fused_ms'] for r in timed):.4f} "
                    f"ms, stats {sum(r['wide_stats_ms'] for r in timed):.4f} ms")
        if all("simt_fused_ms" in r for r in timed):
            loop += (f", the CUDA-core loop: fused {sum(r['simt_fused_ms'] for r in timed):.3f} "
                    f"ms, stats {sum(r['simt_stats_ms'] for r in timed):.3f} ms; fused / loop "
                    f"per shape {min(r['fused_ms'] / r['simt_fused_ms'] for r in timed):.2f}-"
                    f"{max(r['fused_ms'] / r['simt_fused_ms'] for r in timed):.2f}")
        say(f"(i) b{B256} bf16, {kind}: the {len(timed)} timed shapes summed: fused "
            f"{sum(r['fused_ms'] for r in timed):.4f} ms, stats "
            f"{sum(r['stats_ms'] for r in timed):.4f} ms, cuDNN "
            f"{sum(r['cudnn_ms'] for r in timed):.4f} ms, bound "
            f"{sum(r['bound_ms'] for r in timed):.4f} ms; fused / cuDNN per shape "
            f"{min(r['fused_ms'] / r['cudnn_ms'] for r in timed):.2f}-"
            f"{max(r['fused_ms'] / r['cudnn_ms'] for r in timed):.2f}{loop}")

    say("(i) train functions at one new shape each: fn label | dtype | out max|Δ|/max|ref| (tol) "
        "| gradients ‖Δ‖/‖g‖ (tol) [max|Δ|/max|g|] | ReLU mask flips | fwd+bwd kernel_ms "
        "plain_ms library_ms")
    # the largest output of each kind (the shapes sort by H first)
    dil = max(s_ for s_ in dilated if s_[5] == 2 and s_[2] // s_[8] >= 4)
    wide_g4 = max(s_ for (im, s_), kinds in shuffle.items()
                  if im == 32 and "g4" in kinds and s_[2] // s_[8] > 32)
    trains = (("conv_bn_relu_train_grouped", dil), ("grouped_conv2d_train", wide_g4),
              ("conv2d_train", stem))
    for name, (h, w, cin, cout, k, s, p, d, groups) in trains:
        cg = cin // groups
        x32 = torch.randn(KERNEL_BATCH, h, w, cin, device=DEVICE, generator=g)
        w32 = torch.randn(k, k, cg, cout, device=DEVICE, generator=g) / np.sqrt(k * k * cg)
        sc = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        bi = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        work = conv_train_work(KERNEL_BATCH, h, w, cin, cout, k, s, p, groups, d)
        label = f"{h} {cin} {cout} k{k} s{s} p{p} d{d} G{groups}"
        for dtype in (f32, bf16):
            dname = dname_of(dtype)
            x, wt = x32.to(dtype), w32.to(dtype)
            if name == "conv_bn_relu_train_grouped":
                check_trainable(name, label, lambda a, b, c_, e: kernels.conv_bn_relu_train(
                    a, b, c_, e, s, p, groups=groups, dilation=d)[0], [x, wt, sc, bi], dname, g,
                    summary, failures, CONV_TOL[dname][1], work)
            elif name == "grouped_conv2d_train":
                check_trainable(name, label, lambda a, b: kernels.grouped_conv2d_train(
                    a, b, groups, s, p, d), [x, wt], dname, g, summary, failures,
                    CONV_TOL[dname][1], work, conv_lib(s, p, groups, d))
            else:
                check_trainable(name, label, lambda a, b: kernels.conv2d_train(a, b, s, p, d),
                                [x, wt], dname, g, summary, failures, CONV_TOL[dname][1], work,
                                conv_lib(s, p, 1, d))
    return records


def library_convs(prof):
    """Names of the device kernels in a profile that look like a library's
    convolution (LIBRARY_CONV_MARKS), the port's own kernels left out."""
    from torch.autograd import DeviceType

    names = {e.name for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA}
    return sorted(n for n in names if any(m in n.lower() for m in LIBRARY_CONV_MARKS)
                  and not any(o in n for o in OUR_KERNELS))


def served_no_library_conv(label, model, image, seed, failures):
    """One bf16 b256 uint8 request of image² to `model` under the profiler:
    no device kernel of it may be a library's convolution; returns (its
    launches, the device kernels' names, the port's share of device
    time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.serve import ServingModel

    server = ServingModel(model, input_dtype="uint8", stats=IMAGENET_STATS)
    req = np.random.default_rng(seed + 5).integers(0, 256, (ZOO_SERVE_BATCH, image, image, 3),
                                                   dtype=np.uint8)
    server(req)
    sync()
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        logits = server(req)
        sync()
    launches = dict(kernels.LAUNCHES)
    names = sorted({e.name for e in prof.events()
                    if getattr(e, "device_type", None) == DeviceType.CUDA})
    device, ours, _ = device_split(prof, OUR_KERNELS)
    bad = library_convs(prof)
    ok = not bad and ours > 0 and bool(logits.isfinite().all())
    say(f"{label} bf16 b{ZOO_SERVE_BATCH} request under the profiler: launches "
        f"{launches_summary(launches)}; {len(names)} distinct device kernels, the port's "
        f"{ours / 1e3:.3f} of {device / 1e3:.3f} ms; library convolution kernels {bad} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{label} served request ran library convolutions {bad}")
    del server
    return launches, names, ours / max(device, 1e-9)


def zoo2_nobn_step(arch, kind, seed, failures):
    """(ii) one bf16 Adam step of the batch_norm=False net at NOBN_BATCH:
    conv2d_train on every dense conv, grouped_conv2d_train on every grouped
    one (rows 7 and 8), the launches model_launches reads off the model,
    finite loss and gradients. Returns its launches."""
    import torch

    from convnets_tpu_torch.ops import kernels

    model = zoo_model(arch, kind, 32, seed, conv_gain=0.5, batch_norm=False)
    state, step = train_state(model, debug=True)
    rng = np.random.default_rng(seed + 4)
    x = torch.from_numpy(rng.integers(0, 256, (NOBN_BATCH, 32, 32, 3), dtype=np.uint8)).to(DEVICE)
    y = torch.from_numpy(rng.integers(0, ZOO_CLASSES, NOBN_BATCH)).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    sync()
    kernels.reset_launches()
    loss, _, gnorm = step(state, x, y, generator=gen)
    sync()
    launches = dict(kernels.LAUNCHES)
    launches["routes"] = grouped_routes()
    want = model_launches(model)[1]
    ok = ({k: v for k, v in launches.items() if k != "routes"} == want
          and launches["routes"] == grouped_routes_want(model)[1]
          and bool(torch.isfinite(gnorm)) and bool(torch.isfinite(loss)))
    say(f"(ii) bf16 {arch}{kind}@32 batch_norm=False, one Adam step at b{NOBN_BATCH}: launches "
        f"{launches_summary(launches)} (expected {launches_summary(want)}, grouped per route "
        f"{grouped_routes_want(model)[1]}); loss "
        f"{float(loss):.4f}, gradient global norm {float(gnorm):.4e} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{arch}{kind} no-BN step: launches {launches}, loss {float(loss)}, "
                        f"|g| {float(gnorm)}")
    del model, state
    return launches


def zoo2_cli(seed, card, failures):
    """Phase 14 (iii): `python -m convnets_tpu_torch`'s main in process on
    phase 12's PNG tree: fit SE-ResNet-26, SK-ResNet-26 and ShuffleNet-v1-g4
    at b256 for 2 epochs (replayed graphs over DataMngr's
    DeviceCacheLoaders): launches per call, the falling loss, epoch img/s,
    one more epoch under the profiler for the device time per step and the
    idle share; export SK-ResNet-26 and ShuffleNet-g4 (--bake-norm), load
    --testing, and serve the test split from a fresh process (both
    processes started together after the last fit) against Trainer.test's
    argmax. Returns (results, the record, the launches)."""
    import torch

    from convnets_tpu_torch.__main__ import main as cli_main
    from convnets_tpu_torch.data.manager import DataMngr
    from convnets_tpu_torch.ops import kernels

    out, children = {}, []
    n_train, n_test = CLI_SPLITS[0][1], CLI_SPLITS[2][1]
    rec = new_record()
    with tempfile.TemporaryDirectory() as tmp:
        root = cli_tree(seed)
        common = ["--input-size", "3,32,32", "--num-classes", str(ZOO_CLASSES), "--data-root",
                  root, "--seed", str(seed), "--batch-size", str(ZOO2_CLI_BATCH)]
        sync()
        kernels.reset_launches()
        with recorded_trainers(rec):
            for arch, kind in ZOO2_CLI:
                args = ["--arch", arch, "--kind", kind, *common, "--output-dir",
                        os.path.join(tmp, arch)]
                first = (len(rec["train"]), len(rec["eval"]), len(rec["epoch_s"]))
                t0 = time.perf_counter()
                rc = cli_main(["fit", *args, "--epochs", str(CLI_FAMILY_EPOCHS)])
                sync()
                seconds = {"fit": time.perf_counter() - t0}
                trainer = rec["trainers"][-1]
                loss = list(trainer.epoch_results["train_loss"])
                epoch_s = rec["epoch_s"][first[2]:]
                rates = [n_train / t for t in epoch_s]
                ok = (rc == 0 and len(loss) == CLI_FAMILY_EPOCHS and all(np.isfinite(loss))
                      and loss[-1] < loss[0])
                fwd, step = model_launches(trainer.model)
                sub = {"train": rec["train"][first[0]:], "eval": rec["eval"][first[1]:]}
                ok_calls = check_calls(f"{arch}{kind} CLI", sub, step, fwd, failures)
                # two more epochs: the first captures the graphs again (fit
                # ends by loading its best checkpoint), the second, all
                # replays, under the profiler
                t0 = time.perf_counter()
                loader = DataMngr(trainer.setting, root=root, device=DEVICE).load_train()
                steps = len(loader)
                trainer._run_train_epoch(loader, CLI_FAMILY_EPOCHS)
                prof, host, _, _ = profiled_epoch(
                    lambda: trainer._run_train_epoch(loader, CLI_FAMILY_EPOCHS + 1))
                seconds["profiled_epoch"] = time.perf_counter() - t0
                device, ours, _ = device_split(prof, OUR_KERNELS)
                idle = 1.0 - device / 1e6 / host
                timed_idle = 1.0 - device / 1e6 / epoch_s[-1]
                say(f"(iii) CLI fit {arch}{kind}@32 b{ZOO2_CLI_BATCH}, {CLI_FAMILY_EPOCHS} epochs: "
                    f"exit {rc}, train loss {loss} {'ok' if ok else 'FAIL'}; epoch img/s "
                    f"{[round(r, 1) for r in rates]} ({card}); a profiled replayed epoch ({steps} "
                    f"steps): device {device / 1e3 / steps:.3f} ms per step (the port's "
                    f"kernels {ours / 1e3 / steps:.3f}), host {1e3 * host / steps:.3f} ms per "
                    f"step, idle share {idle:.4f} there and {timed_idle:.4f} against the timed "
                    f"epoch {CLI_FAMILY_EPOCHS - 1}")
                if not ok:
                    failures.append(f"zoo2 cli fit {arch}{kind}: exit {rc}, train loss {loss}")
                res = {"train_loss": loss, "epoch_img_s": rates, "launches_ok": ok_calls,
                       "launches_per_train_step": launches_summary(step),
                       "launches_per_eval_call": launches_summary(fwd),
                       "device_ms_per_step": device / 1e3 / steps,
                       "kernels_ms_per_step": ours / 1e3 / steps, "idle_share": idle,
                       "timed_epoch_idle_share": timed_idle, "seconds": seconds}
                if arch in ZOO2_EXPORT:
                    art = os.path.join(tmp, f"{arch}.bin")
                    t0 = time.perf_counter()
                    rc_e = cli_main(["export", *args, "--bake-norm", "--out", art])
                    seconds["export"] = time.perf_counter() - t0
                    rec["capture"] = True
                    rc_t = cli_main(["load", *args, "--testing"])
                    rec["capture"] = False
                    sync()
                    seconds["load_testing"] = time.perf_counter() - t0 - seconds["export"]
                    batches = -(-n_test // ZOO2_CLI_BATCH)
                    timed = rec["eval_io"][-batches:]  # test()'s timed loop
                    xs = torch.cat([x[w > 0] for x, _, w in timed]).numpy()
                    tested = torch.cat([p[w > 0] for _, p, w in timed]).numpy()
                    xfile = os.path.join(tmp, f"{arch}_test_x.npy")
                    np.save(xfile, xs)
                    children.append((arch, kind, rc_e, rc_t, tested, [art, xfile]))
                out[f"{arch}{kind}"] = res
        sync()
        launches = dict(kernels.LAUNCHES)
        launches["routes"] = grouped_routes()
        # the fresh processes, all at once after the fits (each spends most
        # of its time importing torch), so none runs beside a timed epoch
        t0 = time.perf_counter()
        children = [(*c[:5], subprocess.Popen([sys.executable, "-c", CLI_CHILD, HERE, *c[5]],
                                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                              text=True)) for c in children]
        try:
            for arch, kind, rc_e, rc_t, tested, proc in children:
                child = finished(proc, 600)
                served = (json.loads(child.stdout.strip().splitlines()[-1])
                          if child.returncode == 0 else {})
                agree = (float((np.asarray(served.get("argmax", [])) == tested).mean())
                         if len(served.get("argmax", [])) == len(tested) else 0.0)
                ok_art = (rc_e == 0 and rc_t == 0 and child.returncode == 0
                          and agree >= ARGMAX_MIN and len(tested) == n_test)
                say(f"(iii) {arch}{kind} exported (exit {rc_e}) and served by a fresh process on "
                    f"the {len(tested)} test images (launches {served.get('launches')}): argmax = "
                    f"Trainer.test's on {agree:.4f} (min {ARGMAX_MIN}) "
                    f"{'ok' if ok_art else 'FAIL'}")
                if not ok_art:
                    failures.append(f"zoo2 artifact {arch}: rc {rc_e}/{rc_t}/{child.returncode}, "
                                    f"agreement {agree}, {child.stderr[-2000:]}")
                out[f"{arch}{kind}"]["artifact"] = {"agreement": agree,
                                                    "launches": served.get("launches")}
        finally:
            for *_, proc in children:  # none outlives the phase
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        out["serving_processes_s"] = time.perf_counter() - t0
    return out, rec, launches


def phase_zoo2(seed, card, summary, failures):
    """Phase 14: (i) the widened envelopes (zoo2_kernels); (ii) the seven
    models of ZOO2 as phase 12 (i) drives its families (zoo_family), a
    profiled b256 request of SK-ResNet-26 and ShuffleNet-g4 without a
    library convolution, and the batch_norm=False SK-ResNet-26 and
    ShuffleNet-g4 steps; (iii) the CLI (zoo2_cli). Prints the zoo2 JSON
    line; returns the zoo2 path's launches per kernels-line entry."""
    out, parts = {"card": card}, {}
    t0 = time.perf_counter()
    records = zoo2_kernels(summary, failures)
    out["kernels"] = {
        "calls": len(records), "ok": sum(r["ok"] for r in records),
        "routes": {f"{r['dtype']} {r['route']}": sum(1 for q in records if (q["dtype"], q["route"])
                                                      == (r["dtype"], r["route"]))
                   for r in records},
        "worst_fused_err": {d: max(max(r["fused_err"]) for r in records if r["dtype"] == d)
                            for d in ("float32", "bfloat16")},
        "b256": [{k: r[k] for k in ("what", "shape", "route", "fused_ms", "stats_ms", "cudnn_ms",
                                    "bound_ms")} for r in records if "fused_ms" in r]}
    parts["i"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["models"] = {}
    for arch, kind, image in ZOO2:
        t1 = time.perf_counter()
        res, model32 = zoo_family(arch, kind, image, seed, card, failures)
        del model32
        res["seconds"] = time.perf_counter() - t1
        out["models"][f"{arch}{kind}@{image}"] = res
    out["served_kernels"] = {f"{arch}{kind}": served_no_library_conv(
        f"{arch}{kind}@32", zoo_model(arch, kind, 32, seed), 32, seed, failures)[2]
                             for arch, kind in ZOO2_NOBN}
    nobn, nobn_routes = {}, []
    for arch, kind in ZOO2_NOBN:
        launches = zoo2_nobn_step(arch, kind, seed, failures)
        nobn_routes.append(launches.pop("routes"))
        for k, v in launches.items():
            nobn[k] = nobn.get(k, 0) + v
    parts["ii"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["cli"], rec, cli = zoo2_cli(seed, card, failures)
    parts["iii"] = time.perf_counter() - t0
    out["seconds"] = parts

    def in_train(name):
        return sum(c[name] for c in rec["train"]) + nobn[name]

    # rows 1g and 5g per route: the path's, and ShuffleNet-g4@32's per forward and step
    parts = [cli.pop("routes")] + nobn_routes
    route_sums = {name: {r: sum(part[name][r] for part in parts)
                         for r in ("wgmma", "wgmma_wide", "simt")} for name in GROUPED_ROUTED}
    shuffle = out["models"]["shufflenet_v1g4@32"]["grouped_routes"]
    for name in GROUPED_ROUTED:
        entry(summary, name).update(zoo2_route_launches=route_sums[name],
                                    shufflenet_g4_route_launches={
                                        per: shuffle[per][name] for per in ("forward", "step")})
    say(f"zoo2 path: grouped launches per route {route_sums}; ShuffleNet-g4@32 per forward and "
        f"step {shuffle}")
    if not all(route_sums[name]["wgmma_wide"] > 0 for name in GROUPED_ROUTED):
        failures.append(f"the wgmma_wide route: no launch on phase 14's path {route_sums}")
    total = {k: cli[k] + nobn[k] for k in cli}
    path = {k: total[k] for k in ("conv2d_fused", "grouped_conv2d_fused", "max_pool2d",
                                  "avg_pool2d", "conv2d_stats", "conv2d_stats_reduce",
                                  "grouped_conv2d_stats", "pool2d_backward", "depthwise_conv2d",
                                  "bn_act_forward")}
    path.update(conv_bn_relu_train=total["conv2d_stats"],
                bn_act_backward=total["bn_act_backward_apply"],
                conv_bn_relu_train_grouped=total["grouped_conv2d_stats"],
                conv2d_train=in_train("conv2d_fused"),
                grouped_conv2d_train=in_train("grouped_conv2d_fused"),
                depthwise_train=in_train("depthwise_conv2d"),
                pool2d_train=in_train("max_pool2d"), pool2d_train_avg=in_train("avg_pool2d"))
    bn_path = sum(c["conv2d_fused"] for c in rec["train"])
    say(f"zoo2 path (the no-BN steps and the CLI): launches {path}; conv2d_train on a BN "
        f"path (SK-ResNet's attention convs in the CLI fit's steps) {bn_path} "
        f"{'ok' if bn_path > 0 else 'FAIL'}")
    if bn_path <= 0:
        failures.append("conv2d_train: no launch on a BN path")
    out["launches"] = path
    out["conv2d_train_bn_path"] = bn_path
    say(json.dumps({"zoo2": out}))
    return path


# phase 15: the last single-card modules. DenseNet's shared-statistics
# block (CONVNETS_TPU_DENSENET_FUSED, read when a model is built),
# train-mode Remat, the activation trace, the side-stream host feed and
# adaptive_avg_pool2d
FUSED_ENV = "CONVNETS_TPU_DENSENET_FUSED"
REMAT_TURNS = (2, 4)  # (iii)'s b256 turns: (warm-up, timed) steps a run
REMAT_FIT_TRAIN = 2048  # (iv): RN26@32 images, 8 steps of TRAINER_BATCH per epoch
DEBUG_FIT_TRAIN = 2048  # (v)
FEED_STEPS = 6  # (vi): RN50@224 b256 steps from a host DataLoader
DROPOUT_REMAT = 0.5  # (iii): DN121's dropout inside the wrapped blocks
# (vii): (N, H, W, C, output size) of adaptive_avg_pool2d, even bins (the
# avg-pool kernel) and uneven ones (plain PyTorch)
ADAPTIVE_EVEN = ((8, 14, 14, 512, (7, 7)), (8, 7, 7, 1024, (1, 1)), (256, 56, 56, 128, (28, 28)))
ADAPTIVE_UNEVEN = ((8, 7, 7, 1024, (3, 3)), (8, 10, 13, 64, (4, 5)))
# the forward BN passes and the backward nodes (profiler names) that
# (ii)'s split reads: statistics + normalize in one (the standard layout's
# every BN, the fused layout's bn2), the fused layout's shared statistics
# and its normalize with them
BN_RANGES = ("bn_train", "bn_stats", "bn_apply")
BN_BACKWARD = ("_BNCoreBackward", "_BNApplyStatsBackward")


@contextlib.contextmanager
def densenet_fused(on: bool):
    """CONVNETS_TPU_DENSENET_FUSED for the models built inside."""
    old = os.environ.get(FUSED_ENV)
    os.environ[FUSED_ENV] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(FUSED_ENV)
        else:
            os.environ[FUSED_ENV] = old


def fused_blocks(variables):
    """The keys of the dense blocks in a fused DN121's variables."""
    return [k for k, v in variables["state"].items() if "bank_0" in v]


def dn121_pair(seed, mixed, **kw):
    """(standard DN121, fused DN121) at 224² on the card holding the same
    weights: numpy draws in the standard layout, each layer's bn1 running
    statistics made the concatenation of its source blocks' (bank_j is
    layer j's slice of block j, as one update would leave them), and the
    fused layout mapped from them (tests/test_densenet_fused.py:
    _map_params: body 0, 3, 4, 7 are bn1, conv1, bn2, conv2)."""
    from convnets_tpu_torch import bridge
    from convnets_tpu_torch.models import build_model

    std = make_model("densenet", seed, mixed, **kw)
    with densenet_fused(True):
        fused = build_model("densenet", model_setting("densenet", seed, mixed, **kw),
                            device=DEVICE)
    sv = bridge.export_jax_variables(std)
    fv = bridge.export_jax_variables(fused)
    for k in fused_blocks(fv):
        layers = sv["state"][k]
        banks = {}
        for j in range(len(layers)):
            first = layers[str(j)]["1"]["0"]
            c = fv["state"][k][f"bank_{j}"]["mean"].shape[0]
            banks[j] = {leaf: first[leaf][-c:].copy() for leaf in ("mean", "var")}
        params, state = {}, {}
        for i in range(len(layers)):
            body, body_state = sv["params"][k][str(i)]["1"], layers[str(i)]["1"]
            for leaf in ("mean", "var"):
                body_state["0"][leaf] = np.concatenate([banks[j][leaf] for j in range(i + 1)])
            params.update({f"bn1_{i}": body["0"], f"conv1_{i}": body["3"],
                           f"bn2_{i}": body["4"], f"conv2_{i}": body["7"]})
            state[f"bn2_{i}"] = body_state["4"]
            state[f"bank_{i}"] = banks[i]
        fv["params"][k], fv["state"][k] = params, state
    for coll in ("params", "state"):
        for k, v in sv[coll].items():
            if k not in fused_blocks(fv):
                fv[coll][k] = v
    bridge.load_jax_variables(std, sv)
    bridge.load_jax_variables(fused, fv)
    return std, fused


def fused_dn121(seed, mixed, **kw):
    """The fused DN121 at 224² with numpy weights drawn in its own layout."""
    from convnets_tpu_torch import bridge
    from convnets_tpu_torch.models import build_model

    with densenet_fused(True):
        model = build_model("densenet", model_setting("densenet", seed, mixed, **kw),
                            device=DEVICE)
    bridge.load_jax_variables(model, random_jax_variables(model, seed))
    return model


def to_standard_paths(flat):
    """{fused-layout path: v} → {standard-layout path: v} for the dense
    blocks' parameters (conv1_i / bn1_i … → i/1/3, i/1/0 …)."""
    names = {"bn1": "0", "conv1": "3", "bn2": "4", "conv2": "7"}
    out = {}
    for path, v in flat.items():
        hit = [i for i, p in enumerate(path) if p.split("_")[0] in names and "_" in p]
        if hit:
            i = hit[0]
            name, layer = path[i].split("_")
            path = (*path[:i], layer, "1", names[name], *path[i + 1:])
        out[path] = v
    return out


def one_step(model, x, y, lr, gen=None):
    """One SGD step (no momentum or decay) at `lr`; returns (loss, {JAX
    param path: gradient read back as (before − after) / lr}, the JAX state
    tree's leaves)."""
    from convnets_tpu_torch import bridge

    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state, step = train_state(model)
    loss, _ = step(state, x, y, generator=gen)
    sync()
    paths = bridge.param_paths(model)
    grads = {paths[k]: (before[k] - p.detach()) / lr for k, p in model.named_parameters()}
    flat = bridge._flatten(bridge.export_jax_variables(model)["state"])
    return float(loss), grads, {k: v.copy() for k, v in flat.items()}


def step_batch(seed, batch=STEP_BATCH, image=IMAGE, classes=1000):
    import torch

    rng = np.random.default_rng(seed + 2)
    x = torch.from_numpy(rng.integers(0, 256, (batch, image, image, 3), dtype=np.uint8))
    return x.to(DEVICE), torch.from_numpy(rng.integers(0, classes, batch)).to(DEVICE)


SGD_READBACK = dict(optimizer="sgd", learning_rate=2.0 ** 20, momentum=0.0, weight_decay=0.0)


def fused_vs_standard(seed, failures):
    """(i) the fp32 b8 SGD step (dropout 0) of the fused DN121 against the
    standard one with the same weights: loss, each gradient leaf (beside
    the perturbed control), each bank's running statistics against the
    matching bn1's, every other state leaf; then the eval logits."""
    import torch

    x, y = step_batch(seed)
    lr = SGD_READBACK["learning_rate"]
    runs = {}
    std, fused = dn121_pair(seed, False, dropout_rate=0.0, **SGD_READBACK)
    start = {id(m): {k: v.clone() for k, v in m.state_dict().items()} for m in (std, fused)}
    for name in ("standard", "fused", "control"):
        model = fused if name == "fused" else std
        model.load_state_dict(start[id(model)])
        if name == "control":
            gen = torch.Generator(device=DEVICE).manual_seed(seed)
            with torch.no_grad():
                for p in model.parameters():
                    if p.ndim == 4:
                        p.mul_(1 + CONTROL_PERTURBATION * torch.randn(
                            p.shape, device=DEVICE, generator=gen))
        loss, grads, state = one_step(model, x, y, lr)
        if name == "fused":
            grads = to_standard_paths(grads)
        runs[name] = (loss, grads, state)
    (ls, gs, ss), (lf, gf, sf), (_, gc, _) = runs["standard"], runs["fused"], runs["control"]
    loss_rel = abs(lf - ls) / abs(ls)
    same_leaves = set(gf) == set(gs)
    g_l2 = {k: l2_err(gf[k], gs[k]) for k in gs if k in gf}
    c_l2 = {k: l2_err(gc[k], gs[k]) for k in gs}
    worst = max(g_l2, key=g_l2.get)
    bank_err, other_err = 0.0, 0.0
    for path, v in sf.items():
        if path[-2].startswith("bank_"):
            k, j = path[0], int(path[-2].split("_")[1])
            ref = ss[(k, str(j), "1", "0", path[-1])][-v.shape[0]:]  # layer j's bn1, block j
        elif path[-2].startswith("bn2_"):
            ref = ss[(path[0], path[-2].split("_")[1], "1", "4", path[-1])]
        else:
            ref = ss[path]
        err = float(np.abs(v - ref).max() / max(np.abs(ref).max(), 1e-30))
        if path[-2].startswith("bank_"):
            bank_err = max(bank_err, err)
        else:
            other_err = max(other_err, err)
    ok = (same_leaves and loss_rel <= 1e-4 and g_l2[worst] <= STEP_GRAD_TOL
          and bank_err <= 1e-4 and other_err <= 1e-4 and np.isfinite(lf))
    say(f"(i) fp32 DN121 SGD step (b{STEP_BATCH}, dropout 0), fused vs standard layout, same "
        f"weights: loss {lf:.6f} vs {ls:.6f} (rel {loss_rel:.2e}, tol 1e-4); {len(g_l2)} "
        f"gradient leaves, worst ‖Δ‖/‖g‖ {g_l2[worst]:.2e} at {'/'.join(worst)} (tol "
        f"{STEP_GRAD_TOL:g}; control ×(1 + {CONTROL_PERTURBATION:g}·N(0,1)): median "
        f"{float(np.median(list(c_l2.values()))):.2e} max {max(c_l2.values()):.2e}); banks vs "
        f"the matching bn1 running statistics {bank_err:.2e}, every other state leaf "
        f"{other_err:.2e} (tol 1e-4) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"fused DN121 vs standard step: loss {loss_rel:.2e}, grads "
                        f"{g_l2[worst]:.2e}, banks {bank_err:.2e}, state {other_err:.2e}, "
                        f"leaves match {same_leaves}")
    # eval logits, fp32 b8: fused vs standard (the banks hold what the
    # standard layout's bn1s hold), and the fused kernel path vs plain
    for model in (std, fused):
        model.load_state_dict(start[id(model)])
    with torch.no_grad():
        xf = x.float() / 255.0
        ref = std.eval()(xf)
        got = fused.eval()(xf)
        with plain_kernels():
            plain = fused(xf)
    scale = float(ref.abs().max())
    e_std, e_plain = (float((got - r).abs().max()) / scale for r in (ref, plain))
    ok = e_std <= 1e-4 and e_plain <= 1e-4 and bool(torch.isfinite(got).all())
    say(f"(i) fp32 DN121 eval logits (b{STEP_BATCH}): fused vs standard max|Δ|/max|logit| "
        f"{e_std:.2e}, fused kernel vs plain path {e_plain:.2e} (tol 1e-4) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"fused DN121 eval logits: vs standard {e_std:.2e}, vs plain "
                        f"{e_plain:.2e}")
    return {"loss_rel": loss_rel, "worst_grad_l2": g_l2[worst],
            "control_worst_grad_l2": max(c_l2.values()), "bank_rel": bank_err,
            "eval_vs_standard": e_std, "eval_vs_plain": e_plain}


@contextlib.contextmanager
def bn_ranges():
    """Each forward BN pass of the models under a torch.profiler range of
    BN_RANGES (ops.batch_norm_train, ops.batch_stats, ops.bn_apply_stats,
    as the layers call them through the ops package)."""
    from torch.profiler import record_function

    from convnets_tpu_torch import ops

    saved = {name: getattr(ops, name) for name in ("batch_norm_train", "batch_stats",
                                                   "bn_apply_stats")}

    def ranged(label, fn):
        def call(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        return call

    for label, name in zip(BN_RANGES, saved):
        setattr(ops, name, ranged(label, saved[name]))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def bn_split(prof, per):
    """Device ms per step (`per` steps traced) of the kernels launched under
    each BN range and each BN backward node of a profile: the host-side
    events' device time, their children's included (the range's own
    device-side annotation and the node's inner event left out, which
    would count the same kernels again)."""
    from torch.autograd import DeviceType

    names = {**{label: label for label in BN_RANGES},
             **{f"autograd::engine::evaluate_function: {label}": label for label in BN_BACKWARD}}
    out = {label: 0.0 for label in BN_RANGES + BN_BACKWARD}
    for e in prof.events():
        if e.name in names and getattr(e, "device_type", None) == DeviceType.CPU:
            out[names[e.name]] += float(getattr(e, "device_time_total", 0.0)) / per / 1e3
    return out


def annotation_us(prof):
    """Device µs of the BN ranges' device-side annotations (spans, not
    kernels), which device_split counts among the device events."""
    from torch.autograd import DeviceType

    return sum(float(getattr(e, "device_time_total", 0.0) or 0.0) for e in prof.events()
               if e.name in BN_RANGES and getattr(e, "device_type", None) == DeviceType.CUDA)


def turns_throughput(label, models, seed, failures, want=None, depth=(WARMUP, TIMED),
                     path=None):
    """bf16 b256 train steps with bench.py's settings, the models in turns
    (steps_in_turns): img/s, peak memory, launches per step (each run
    exactly `want[name]` where given); then three profiled steps each with
    the BN split. Returns {name: summary}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randint(0, 256, (B256, IMAGE, IMAGE, 3), dtype=torch.uint8, device=DEVICE,
                      generator=gen)
    y = torch.randint(0, 1000, (B256,), device=DEVICE, generator=gen)
    steps = {name: train_state(m) for name, m in models.items()}
    names = list(models)
    turns = steps_in_turns(label, {name: (*steps[name], contextlib.nullcontext)
                                   for name in names}, x, y, gen, failures, want, depth, path)
    runs = {name: [B256 / t for t in turns[name]["seconds"]] for name in names}
    peaks = {name: turns[name]["peak"] for name in names}
    out = {}
    for name in names:
        state, step = steps[name]
        with bn_ranges(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step(state, x, y, generator=gen)
            sync()
        device, ours, bwd = device_split(prof, OUR_KERNELS)
        device -= annotation_us(prof)
        out[name] = {"img_s": runs[name], "peak_gib": peaks[name] / 2 ** 30,
                     "device_ms_per_step": device / 3e3, "kernels_ms_per_step": ours / 3e3,
                     "backward_convs_ms_per_step": bwd / 3e3, "bn_ms_per_step": bn_split(prof, 3)}
    say(f"{label}, bf16 b{B256} (Adam, wd 1e-4, dropout 0.5, uint8 batch on the card), in turns "
        f"({depth[0]} + {depth[1]} steps a run):")
    for name, r in out.items():
        bn = ", ".join(f"{k} {v:.3f}" for k, v in r["bn_ms_per_step"].items())
        say(f"    {name}: img/s {[round(v, 1) for v in r['img_s']]}, peak memory "
            f"{r['peak_gib']:.2f} GiB; device ms per step (profiler, 3 steps) "
            f"{r['device_ms_per_step']:.3f}: the port's kernels {r['kernels_ms_per_step']:.3f}, "
            f"backward convs {r['backward_convs_ms_per_step']:.3f}; BN passes {bn}")
    del steps
    return out


def remat_launches(model):
    """The launches a remat train step adds: each Remat's child's train
    forward once more, read off the modules (model_layers inside_remat)."""
    kinds = [layer[0] for layer in model_layers(model, inside_remat=True)]
    n = {k: kinds.count(k) for k in ("conv", "gconv", "dwconv", "plainconv", "plaingconv",
                                     "plaindwconv", "maxpool", "avgpool")}
    return launches_of({"conv2d_stats": n["conv"], "grouped_conv2d_stats": n["gconv"],
                        "conv2d_stats_reduce": n["conv"] + n["gconv"],
                        **bn_sites(n["conv"] + n["gconv"], backward=False),
                        "conv2d_fused": n["plainconv"], "grouped_conv2d_fused": n["plaingconv"],
                        "depthwise_conv2d": n["dwconv"] + n["plaindwconv"],
                        "max_pool2d": n["maxpool"], "avg_pool2d": n["avgpool"]})


def remat_want(model):
    """Launches per remat train step: the step's without remat plus the
    recomputed forwards'."""
    base, extra = model_launches(model)[1], remat_launches(model)
    return {k: base[k] + extra[k] for k in base}


def remat_checks(seed, failures, path):
    """(iii) Remat against no remat: the fp32 b8 SGD step of RN50 and the
    fused DN121 (BN buffers bit for bit, gradients within the step bar,
    launches exact), the fused DN121 with dropout 0.5 inside the wrapped
    blocks (within the bar; a recompute that redraws its masks outside
    it); then bf16 b256 img/s and peak memory in turns."""
    import torch

    from convnets_tpu_torch import nn
    from convnets_tpu_torch.nn.module import MaskTape
    from convnets_tpu_torch.ops import kernels

    x, y = step_batch(seed)
    lr = SGD_READBACK["learning_rate"]
    makers = {"RN50": lambda mixed, **kw: make_model("resnet", seed, mixed, **kw),
              "DN121-fused": lambda mixed, **kw: fused_dn121(seed, mixed, **kw)}
    res = {}
    for label, make in makers.items():
        cases = [("dropout 0", 0.0, None)]
        if label == "DN121-fused":
            cases.append((f"dropout {DROPOUT_REMAT:g}", DROPOUT_REMAT, "redrawn"))
        for what, rate, control in cases:
            runs = {}
            for remat in (False, True) + ((control,) if control else ()):
                model = make(False, dropout_rate=rate, remat=bool(remat), **SGD_READBACK)
                gen = torch.Generator(device=DEVICE).manual_seed(seed + 7)
                want = remat_want(model) if remat else model_launches(model)[1]
                kernels.reset_launches()
                if remat == "redrawn":
                    kept = MaskTape.next_mask
                    fresh = torch.Generator(device=DEVICE).manual_seed(99)

                    def redraw(self, shape, kept=kept, fresh=fresh):
                        kept(self, shape)  # moves the tape's cursor on
                        return torch.rand(shape, generator=fresh, device=DEVICE) < (
                            1.0 - DROPOUT_REMAT)

                    MaskTape.next_mask = redraw
                    try:
                        runs[remat] = one_step(model, x, y, lr, gen)
                    finally:
                        MaskTape.next_mask = kept
                else:
                    runs[remat] = one_step(model, x, y, lr, gen)
                launches = dict(kernels.LAUNCHES)
                for k, v in launches.items():
                    path[k] = path.get(k, 0) + v
                if remat is True and launches != want:
                    failures.append(f"remat {label} {what} step launches "
                                    f"{launches_summary(launches)} != {launches_summary(want)}")
                if remat is True:
                    res[f"{label} {what} launches"] = launches_summary(launches)
                    wrapped = sum(isinstance(m, nn.Remat) for m in model.modules())
                del model
            (l0, g0, s0), (l1, g1, s1) = runs[False], runs[True]
            gaps = {k: l2_err(g1[k], g0[k]) for k in g0}
            worst = max(gaps, key=gaps.get)
            buffers_equal = set(s0) == set(s1) and all(np.array_equal(s0[k], s1[k]) for k in s0)
            ok = buffers_equal and gaps[worst] <= STEP_GRAD_TOL and np.isfinite(l1)
            text = ""
            if control:
                cg = runs[control][1]
                c_gaps = {k: l2_err(cg[k], g0[k]) for k in g0}
                rejects = max(c_gaps.values()) > STEP_GRAD_TOL
                ok = ok and rejects
                text = (f"; the control whose recompute redraws its masks: worst "
                        f"{max(c_gaps.values()):.2e}, outside the bar: "
                        f"{'ok' if rejects else 'FAIL'}")
                res[f"{label} {what} control_worst"] = max(c_gaps.values())
            say(f"(iii) fp32 {label} SGD step (b{STEP_BATCH}, {what}), remat ({wrapped} wrapped "
                f"modules) vs none: loss {l1:.6f} vs {l0:.6f}; BN buffers bit for bit "
                f"{buffers_equal}; worst gradient ‖Δ‖/‖g‖ {gaps[worst]:.2e} at "
                f"{'/'.join(worst)} (tol {STEP_GRAD_TOL:g}); launches "
                f"{res[f'{label} {what} launches']}{text} {'ok' if ok else 'FAIL'}")
            res[f"{label} {what} worst"] = gaps[worst]
            if not ok:
                failures.append(f"remat {label} {what}: buffers equal {buffers_equal}, grads "
                                f"{gaps[worst]:.2e}{text}")
    for label, make in makers.items():
        models = {"no remat": make(True), "remat": make(True, remat=True)}
        want = {"no remat": model_launches(models["no remat"])[1],
                "remat": remat_want(models["remat"])}
        want = {k: {n: float(c) for n, c in v.items()} for k, v in want.items()}
        res[f"{label} b{B256}"] = turns_throughput(f"(iii) {label} remat", models, seed,
                                                   failures, want, REMAT_TURNS, path)
        del models
    return res


def remat_fit_check(seed, out_dir, failures):
    """(iv) RN26@32 with remat=True over a DeviceCacheLoader: the replayed
    epochs against the per-step loop and the per-step loop again (the
    control), phase 13's protocol (hold_to_control), with every replay's
    launches exact (the step's without remat plus the recomputed
    forwards'). Returns (results, the graphed trainer's launches)."""
    from convnets_tpu_torch.data import ArrayDataset, DeviceCacheLoader
    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.train import Trainer

    train_ds, _ = trainer_data(seed)
    train_ds = ArrayDataset(train_ds.images[:REMAT_FIT_TRAIN], train_ds.labels[:REMAT_FIT_TRAIN])
    setting = trainer_setting(seed, out_dir, remat=True, data_augment=True,
                              augment_affine=True, data_norm=True, cutout=AUG_CUTOUT,
                              mixup=AUG_MIXUP)
    routes = ("graphed", "per_step", "control")
    trainers, loaders, calls, path = {}, {}, new_record(), {}
    first = None
    for name in routes:
        model = build_model("resnet", setting, device=DEVICE)
        if first is None:
            first = model.state_dict()
        model.load_state_dict(first)
        trainers[name] = Trainer(model)
        trainers[name]._new_state()
        loaders[name] = DeviceCacheLoader(train_ds, TRAINER_BATCH, shuffle=True, seed=seed,
                                          device=DEVICE)
        loaders[name].augment, loaders[name].normalize = True, True
        loaders[name].scan_epochs = name == "graphed"
    count_calls(trainers["graphed"], calls)
    results = {name: [] for name in routes}
    for e in range(GRAPH_EPOCHS):
        for name in routes if e % 2 == 0 else routes[::-1]:
            def epoch(name=name, e=e):
                return trainers[name]._run_train_epoch(loaders[name], e)
            results[name].append(counted_run(epoch, path) if name == "graphed" else epoch())
    leaves = {name: run_leaves(trainers[name], results[name]) for name in routes}
    exact, worst, cworst = hold_to_control(
        f"(iv) RN26@32 remat=True, {GRAPH_EPOCHS} epochs of {len(loaders['graphed'])} steps, "
        f"graphed vs per-step: every parameter and BN buffer, each epoch's loss and score",
        leaves["graphed"], leaves["per_step"], leaves["control"], "the per-step route twice",
        failures)
    model = trainers["graphed"].model
    want = remat_want(model)
    replays = {g.kind: launches_summary(g.per_replay[0]) for g in graphs_of(trainers["graphed"])
               if g.per_replay}
    ok = (len(calls["train"]) == len(loaders["graphed"]) * GRAPH_EPOCHS
          and all(c == want for c in calls["train"]) and "train" in replays)
    say(f"(iv) launches: {len(calls['train'])} graphed steps, each {launches_summary(want)} "
        f"(the step's "
        f"{launches_summary(model_launches(model)[1])} plus the recomputed forwards' "
        f"{launches_summary(remat_launches(model))}); per replay, counted at the capture: "
        f"{replays} {'ok' if ok else 'FAIL'}; losses graphed {results['graphed']}")
    if not ok:
        failures.append(f"remat graphed epoch launches: {[c for c in calls['train'] if c != want][:1]}")
    for t in trainers.values():
        t.close()
    return {"bit_identical": exact, "worst_gap": worst, "control_gap": cworst,
            "per_step_launches": launches_summary(want), "results": results}, path


def forward_modules(model) -> int:
    """The modules whose forward runs in an eval forward, read off the
    model: every module under the root but the children of a fused
    ConvBNReLU (a dense or grouped conv without bias), which its kernel
    computes without calling them."""
    from convnets_tpu_torch import nn
    from convnets_tpu_torch.nn.layers import DEPTHWISE, _check_conv_envelope

    skipped = set()
    for mod in model.module.modules():
        if isinstance(mod, nn.ConvBNReLU):
            conv = mod._modules["0"]
            cin = conv.weight.shape[2] * conv.groups
            if conv.bias is None and _check_conv_envelope(conv, cin) != DEPTHWISE:
                skipped.update(id(m) for m in mod._modules.values())
    return sum(id(mod) not in skipped for mod in model.module.modules())


def debug_fit_check(seed, out_dir, failures):
    """(v) fit(debug=True), one RN26@32 epoch from a host DataLoader: the
    summary and one trace line per module that runs before the first
    epoch, every value finite, the epoch per-step; then a replayed epoch
    over a DeviceCacheLoader with the step's launches exact and no hook
    left on any module. Returns (results, launches)."""
    import io

    from convnets_tpu_torch.data import ArrayDataset, DataLoader, DeviceCacheLoader
    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.train import Trainer

    train_ds, valid_ds = trainer_data(seed)
    train_ds = ArrayDataset(train_ds.images[:DEBUG_FIT_TRAIN], train_ds.labels[:DEBUG_FIT_TRAIN])
    valid_ds = ArrayDataset(valid_ds.images[:TRAINER_BATCH], valid_ds.labels[:TRAINER_BATCH])
    setting = trainer_setting(seed, out_dir, epochs=1, debug=True)
    trainer = Trainer(build_model("resnet", setting, device=DEVICE))
    calls, path = new_record(), {}
    count_calls(trainer, calls)
    out = io.StringIO()
    loaders = [DataLoader(ds, TRAINER_BATCH, shuffle=ds is train_ds, seed=seed)
               for ds in (train_ds, valid_ds)]
    with contextlib.redirect_stdout(out):
        counted_run(lambda: trainer.fit(*loaders), path)
    text = out.getvalue()
    lines = [ln for ln in text.splitlines() if ln.startswith("[trace] ")]
    want = forward_modules(trainer.model)
    values = [float(v) for ln in lines for v in (ln.split("mean=")[1].split()[0],
                                                 ln.split("std=")[1])]
    first_epoch = text.find("grad_norm=")
    per_step = not graphs_of(trainer) and len(calls["train"]) == len(loaders[0])
    ok = (len(lines) == want and all(np.isfinite(values)) and per_step
          and 0 <= text.find(lines[-1]) < first_epoch and "total params" in text)
    say(f"(v) fit(debug=True), RN26@32, {len(loaders[0])} steps from a host DataLoader: "
        f"{len(lines)} trace lines before the first epoch (modules whose forward runs, read off "
        f"the model: {want}), all finite {all(np.isfinite(values))}; per-step {per_step} "
        f"{'ok' if ok else 'FAIL'}\n    first: {lines[0] if lines else None}\n    last:  "
        f"{lines[-1] if lines else None}")
    if not ok:
        failures.append(f"debug fit: {len(lines)} trace lines (want {want}), per-step {per_step}")
    hooks = sum(len(m._forward_hooks) + len(m._forward_pre_hooks)
                for m in trainer.model.modules())
    trainer.setting.debug = False
    cached = DeviceCacheLoader(train_ds, TRAINER_BATCH, shuffle=True, seed=seed, device=DEVICE)
    calls["train"].clear()
    counted_run(lambda: trainer._run_train_epoch(cached, 1), path)
    step_want = model_launches(trainer.model)[1]
    ok = (hooks == 0 and bool(graphs_of(trainer)) and calls["train"]
          and all(c == step_want for c in calls["train"]))
    say(f"(v) then a replayed epoch ({len(calls['train'])} steps): each "
        f"{launches_summary(step_want)}; forward hooks left on the model {hooks} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"after the debug fit: hooks {hooks}, launches "
                        f"{[c for c in calls['train'] if c != step_want][:1]}")
    trainer.close()
    return {"trace_lines": len(lines), "modules": want, "hooks_left": hooks}, path


# runtime calls that allocate pinned host memory or make the host wait for
# the device, counted in (vi)'s profiles
HOST_WAITS = ("cudaHostAlloc", "cudaMallocHost", "cuMemHostAlloc", "cudaStreamSynchronize",
              "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy", "cudaFreeHost")


def copy_timeline(prof):
    """The host-to-device copies of a profile's Chrome trace: their streams
    and the kernels' ("copy_streams", "kernel_streams"), their device µs
    and the µs of it that overlaps a kernel ("copy_us", "overlap_us"), the
    HOST_WAITS calls by name ("waits") and how many of them lie between
    the first and the last image copy's call ("waits_between"), and for each
    copy of 1 MiB or more (an image batch)
    its backlog: the µs from its cudaMemcpyAsync call to the device end of
    the last kernel launched before that call, ≤ 0 where the device had
    run out of work when the copy was issued, None before the first kernel
    ("backlog_us"; empty where the trace holds no runtime calls)."""
    import bisect
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    calls = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    end_of = lambda e: float(e["ts"]) + float(e.get("dur", 0))
    spans = sorted((float(e["ts"]), end_of(e)) for e in kernels)
    total = overlap = 0.0
    for c in copies:
        a, b = float(c["ts"]), end_of(c)
        total += b - a
        covered, end = 0.0, a
        for s0, s1 in spans:
            if s1 <= end or s0 >= b:
                continue
            lo = max(s0, end)
            covered += max(0.0, min(s1, b) - lo)
            end = max(end, min(s1, b))
        overlap += covered
    corr = lambda e: e.get("args", {}).get("correlation")
    issued = {corr(e): float(e["ts"]) for e in calls if corr(e) is not None}
    launched = sorted((issued[corr(k)], end_of(k)) for k in kernels if corr(k) in issued)
    ends, last = [], float("-inf")
    for _, t in launched:
        last = max(last, t)
        ends.append(last)
    starts = [t for t, _ in launched]
    backlog = []
    for c in sorted(copies, key=lambda e: float(e["ts"])):
        at = issued.get(corr(c))
        if at is None or c.get("args", {}).get("bytes", 1 << 20) < 1 << 20:
            continue
        i = bisect.bisect_left(starts, at)
        backlog.append(ends[i - 1] - at if i else None)  # None: no kernel before it
    image_calls = [issued[corr(c)] for c in copies if corr(c) in issued
                   and c.get("args", {}).get("bytes", 1 << 20) >= 1 << 20]
    first, last = (min(image_calls), max(image_calls)) if image_calls else (0.0, -1.0)
    waits, waits_between = {}, 0
    for e in calls:
        if e.get("name") in HOST_WAITS:
            waits[e["name"]] = waits.get(e["name"], 0) + 1
            waits_between += first <= float(e["ts"]) <= last
    stream = lambda e: e.get("args", {}).get("stream")
    return {"copy_streams": {stream(e) for e in copies},
            "kernel_streams": {stream(e) for e in kernels}, "copy_us": total,
            "overlap_us": overlap, "waits": waits, "waits_between": waits_between,
            "backlog_us": backlog}


def side_stream_check(seed, failures):
    """(vi) RN50@224 bf16 b256, FEED_STEPS steps from a host DataLoader of
    uint8 images through device_prefetch (side-stream copies) against the
    same steps over the same batches placed on the card beforehand:
    parameters and buffers bit for bit; two profiled runs, one with the
    CPU and CUDA activities and one with the CUDA activity alone (no host
    op records): every H2D
    copy on a stream of its own, the share of copy time that overlaps
    kernels, the device's backlog as each image copy was issued, the
    pinned allocations and host waits (copy_timeline); in the unprofiled
    fed run, the compute work still queued as each batch was asked for
    (CUDA events); and the per-step img/s. Returns (results, launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from convnets_tpu_torch.core.rng import generator_for
    from convnets_tpu_torch.data import ArrayDataset, DataLoader, device_prefetch

    rng = np.random.default_rng(seed + 6)
    n = FEED_STEPS * B256
    ds = ArrayDataset(rng.integers(0, 256, (n, IMAGE, IMAGE, 3), dtype=np.uint8),
                      rng.integers(0, 1000, n).astype(np.int32))
    loader = DataLoader(ds, B256, shuffle=False, seed=seed)
    placed = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE) for a in b)
              for b in loader]
    sync()
    runs, path, seconds, timelines = {}, {}, {}, {}
    profiled = {"profiled": [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                "profiled_cuda": [ProfilerActivity.CUDA]}
    marks = []

    def marked(batches):
        """The host batches, recording as device_prefetch asks for each an
        event on the compute stream beside one on an idle stream: the time
        between them is the compute work still queued then."""
        idle = torch.cuda.Stream(DEVICE)
        for b in batches:
            asked, drained = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            asked.record(idle)
            drained.record(torch.cuda.current_stream(DEVICE))
            marks.append((asked, drained))
            yield b

    for name in ("placed", "fed", *profiled):
        model = make_model("resnet", seed, True)
        state, step = train_state(model)
        batches = (placed if name == "placed" else
                   device_prefetch(marked(loader) if name == "fed" else loader, 2, DEVICE))

        def run(batches=batches, state=state, step=step):
            for s, (x, y, w) in enumerate(batches):
                step(state, x, y.long(), w, generator=generator_for(seed, "dropout", 0, s,
                                                                     device=DEVICE))
            sync()

        sync()
        t0 = time.perf_counter()
        if name in profiled:
            with profile(activities=profiled[name]) as prof:
                counted_run(run, path)
            seconds[name] = time.perf_counter() - t0
            timelines[name] = copy_timeline(prof)
        else:
            counted_run(run, path)
            seconds[name] = time.perf_counter() - t0
        runs[name] = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del model, state, step
    exact = all(torch.equal(runs["fed"][k], runs["placed"][k]) for k in runs["placed"])
    queued = [asked.elapsed_time(drained) for asked, drained in marks]
    copy_streams = set().union(*(t["copy_streams"] for t in timelines.values()))
    kernel_streams = set().union(*(t["kernel_streams"] for t in timelines.values()))
    own = bool(copy_streams) and not copy_streams & kernel_streams
    rate = {k: n / v for k, v in seconds.items()}
    ok = exact and own
    say(f"(vi) RN50@224 bf16 b{B256}, {FEED_STEPS} steps from a host DataLoader of uint8 images "
        f"(side-stream copies) vs the same batches placed on the card first: parameters and "
        f"buffers bit for bit {exact}; profiled runs: H2D copies on streams {sorted(copy_streams)}, "
        f"kernels on {sorted(kernel_streams)} (the copies on a stream of their own: {own}); "
        f"img/s fed {rate['fed']:.1f}, placed {rate['placed']:.1f} {'ok' if ok else 'FAIL'}")
    say(f"    fed, unprofiled: the compute work still queued as each batch was asked for (ms, "
        f"CUDA events) {[round(q, 3) for q in queued]}")
    for name, t in timelines.items():
        backlog = [None if b is None else round(b / 1e3, 3) for b in t["backlog_us"]]
        say(f"    {name} ({'+'.join(a.name for a in profiled[name])} activity, "
            f"{rate[name]:.1f} img/s): copy time {t['copy_us'] / 1e3:.3f} ms, "
            f"{100 * t['overlap_us'] / max(t['copy_us'], 1e-9):.1f}% of it overlapping kernels; "
            f"the device's backlog when each batch's image copy was issued (ms; ≤ 0: the device "
            f"had run out of work) {backlog}; pinned allocations and host waits {t['waits']}, "
            f"{t['waits_between']} of them between the first and the last image copy")
    if not ok:
        failures.append(f"side-stream feed: bit for bit {exact}, copy streams "
                        f"{sorted(copy_streams)} vs kernel streams {sorted(kernel_streams)}")
    return {"bit_identical": exact, "copy_streams": sorted(copy_streams),
            "kernel_streams": sorted(kernel_streams), "img_s": rate, "queued_ms": queued,
            "profiles": {name: {"copy_ms": t["copy_us"] / 1e3,
                                "overlap_share": t["overlap_us"] / max(t["copy_us"], 1e-9),
                                "backlog_ms": [None if b is None else b / 1e3
                                               for b in t["backlog_us"]],
                                "waits": t["waits"], "waits_between": t["waits_between"]}
                         for name, t in timelines.items()}}, path


def adaptive_pool_check(summary, failures):
    """(vii) nn.AdaptiveAvgPool2d (eval) on the card: each even case
    exactly one avg_pool2d launch per call, within row 3's bars against the
    plain avg pool, fp32 and bf16; each uneven case against
    ops.adaptive_avg_pool2d on the CPU within 1e-6 relative in fp32.
    Returns the launches."""
    import torch

    from convnets_tpu_torch import nn, ops
    from convnets_tpu_torch.ops import kernels

    g = torch.Generator(device=DEVICE).manual_seed(15)
    path, worst = {}, 0.0
    for n, h, w, c, out in ADAPTIVE_EVEN:
        pool = nn.AdaptiveAvgPool2d(out).eval()
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(n, h, w, c, device=DEVICE, generator=g).to(dtype)
            got = counted_run(lambda: pool(x), path)
            calls = kernels.LAUNCHES["avg_pool2d"]
            k = (h // out[0], w // out[1])
            ref = kernels.avg_pool2d_plain(x, k, k, 0)
            err = float((got.float() - ref.float()).abs().max())
            ok = calls == 1 and tuple(got.shape) == (n, *out, c) and avg_pool_ok(
                got, ref, dname_of(dtype))
            worst = max(worst, err)
            say(f"(vii) adaptive_avg_pool2d even {n}x{h}x{w}x{c} → {out} {dname_of(dtype)}: "
                f"avg_pool2d launches {calls} (want 1), max|Δ| vs plain {err:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"adaptive_avg_pool2d even {(n, h, w, c, out)} "
                                f"{dname_of(dtype)}: launches {calls}, err {err:.3e}")
    entry(summary, "avg_pool2d")["err"] = max(entry(summary, "avg_pool2d")["err"], worst)
    for n, h, w, c, out in ADAPTIVE_UNEVEN:
        x = torch.randn(n, h, w, c, device=DEVICE, generator=g)
        got = counted_run(lambda: nn.AdaptiveAvgPool2d(out).eval()(x), path)
        ref = ops.adaptive_avg_pool2d(x.cpu(), out)
        err = rel_err(got.cpu(), ref)
        ok = err <= AVG_POOL_TOL and kernels.LAUNCHES["avg_pool2d"] == 0
        say(f"(vii) adaptive_avg_pool2d uneven {n}x{h}x{w}x{c} → {out} fp32: max|Δ|/max|ref| vs "
            f"the CPU {err:.2e} (tol {AVG_POOL_TOL:g}), no kernel launch {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"adaptive_avg_pool2d uneven {(n, h, w, c, out)}: {err:.2e}")
    return path


def train_entries(totals):
    """A train path's launches per kernels-line entry: each kernel's count,
    conv_bn_relu_train by its conv2d_stats launches, conv2d_train by the
    conv2d_fused launches (in a train step every one is a plain conv's
    forward), pool2d_train and pool2d_train_avg by the max and avg pool
    forwards."""
    out = {k: totals.get(k, 0) for k in ("conv2d_fused", "max_pool2d", "avg_pool2d",
                                          "conv2d_stats", "conv2d_stats_reduce",
                                          "pool2d_backward", "bn_act_forward")}
    out.update(conv_bn_relu_train=totals.get("conv2d_stats", 0),
               bn_act_backward=totals.get("bn_act_backward_apply", 0),
               conv2d_train=totals.get("conv2d_fused", 0),
               pool2d_train=totals.get("max_pool2d", 0),
               pool2d_train_avg=totals.get("avg_pool2d", 0))
    return {k: v for k, v in out.items() if v}


def phase_last_modules(seed, card, summary, failures):
    """Phase 15 (i)-(vii). Returns {path: launches per kernels-line entry}."""
    import tempfile

    out = {}
    paths = {}
    # (i) DN121-fused against the standard layout
    out["fused_vs_standard"] = fused_vs_standard(seed, failures)
    step_check("densenet (fused)", seed, failures,
               make=lambda **kw: fused_dn121(seed, False, **kw))
    fused = fused_dn121(seed, True)
    served = served_no_library_conv("(i) DN121-fused@224", fused, IMAGE, seed, failures)[0]
    want = launches_of(SERVE_LAUNCHES["densenet"])
    if served != want:
        failures.append(f"fused DN121 served launches {launches_summary(served)} != "
                        f"{launches_summary(want)}")
    del fused
    # (ii) the b256 train step, standard and fused in turns
    train_path = {}
    models = {"standard": make_model("densenet", seed, True), "fused": fused_dn121(seed, True)}
    want = {k: {n: float(c) for n, c in launches_of(TRAIN_LAUNCHES["densenet"]).items()}
            for k in models}
    out["dn121_b256"] = turns_throughput("(ii) DN121, standard and fused layouts", models, seed,
                                         failures, want, path=train_path)
    del models
    # (iii) Remat on RN50 and the fused DN121
    out["remat"] = remat_checks(seed, failures, train_path)
    paths["fused_densenet"] = {**train_entries(train_path), "conv2d_fused":
                               train_path.get("conv2d_fused", 0) + served["conv2d_fused"]}
    with tempfile.TemporaryDirectory() as tmp:
        # (iv) the replayed remat fit
        out["remat_fit"], fit_path = remat_fit_check(seed, tmp, failures)
        # (v) the debug fit
        out["debug_fit"], debug_path = debug_fit_check(seed, tmp, failures)
    # (vi) the side-stream feed
    out["side_stream"], feed_path = side_stream_check(seed, failures)
    # (vii) adaptive_avg_pool2d
    pool_path = adaptive_pool_check(summary, failures)
    fits = {}
    for p in (fit_path, debug_path, feed_path):
        for k, v in p.items():
            fits[k] = fits.get(k, 0) + v
    paths["remat_debug_feed"] = train_entries(fits)
    paths["adaptive_pool"] = {"avg_pool2d": pool_path.get("avg_pool2d", 0)}
    say(json.dumps({"last_modules": {"card": card, **out}}, default=str))
    return paths


# phase 16: data parallel (convnets_tpu_torch/parallel) on the one card.
# (i) a world of one rank over NCCL: phase 13's replayed RN26@32 fit with a
# mesh against the same fit without one; (ii) two ranks that share the card
# over gloo (NCCL refuses two ranks on one device, which (ii) confirms
# first): RN50@224 with bench.py's settings at a global batch of 256; (iii)
# the CLI under torchrun; (iv) dryrun_multichip(2, "cuda").
DP_EPOCHS = 2  # (i)
DP_RANK_BATCH = 128  # (ii): 2 ranks, a global batch of 256
DP_DEPTH = (2, 6)  # (ii): warm-up and timed steps, the first 8 of DP_LEARN_STEPS
DP_LEARN_STEPS = 10  # (ii): bf16 Adam steps on one global batch, the loss must fall
DP_CHECK_BATCH = 8  # (ii): the fp32 SGD step, 2 × 4 against one process at 8
DP_TIMEOUT = 900  # (ii)-(iv): seconds for a group of rank processes
DP_PROBE_TIMEOUT = 120  # (ii): the NCCL probe of two ranks on one card
DP_CLI_EPOCHS = 1  # (iii)
# (iii): installed as the torchrun worker's sitecustomize (a directory put
# first on PYTHONPATH), it records that process's Trainers as phase 12's
# in-process CLI records its own, and writes the record at exit; it then
# runs the sitecustomize it shadows, if there is one
DP_SITE = """
import os
if "RANK" in os.environ and os.environ.get("CHIP_SMOKE_RECORD"):
    import atexit, json, sys
    sys.path.insert(0, os.environ["CHIP_SMOKE_HERE"])
    import chip_smoke
    rec = chip_smoke.new_record()
    rec["capture"] = True
    _recording = chip_smoke.recorded_trainers(rec)  # kept: its exit would end the recording
    _recording.__enter__()

    def _dump():
        t = rec["trainers"][0]
        per_eval, per_step = chip_smoke.model_launches(t.model)
        timed = rec["eval_io"][-int(os.environ["CHIP_SMOKE_TEST_BATCHES"]):]
        preds = [p[w > 0].tolist() for _, p, w in timed]
        with open(os.environ["CHIP_SMOKE_RECORD"], "w") as f:
            json.dump({"train": rec["train"], "eval": rec["eval"], "per_step": per_step,
                       "per_eval": per_eval, "test_preds": sum(preds, []),
                       "world": t.world, "mesh": t.mesh is not None,
                       "epoch_s": rec["epoch_s"]}, f)

    atexit.register(_dump)
import importlib.machinery, importlib.util, sys as _sys
_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in _sys.path if os.path.abspath(p or ".") != _here])
if _spec is not None:
    _mod = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_mod)
"""


def dp_world_one(seed, out_dir, card, failures):
    """Phase 16 (i). Returns (results, the mesh fit's launches)."""
    import torch
    import torch.distributed as dist

    from convnets_tpu_torch.data import ArrayDataset, DeviceCacheLoader
    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.parallel import init_distributed, make_mesh
    from convnets_tpu_torch.train import Trainer
    from convnets_tpu_torch.train.graph import WARMUP_STEPS

    res, path = {}, {}
    init_distributed("file://" + os.path.join(out_dir, "nccl-store"), 1, 0, device=DEVICE)
    try:
        mesh = make_mesh()
        train_ds, valid_ds = trainer_data(seed)
        train_ds = ArrayDataset(train_ds.images[:GRAPH_TRAIN], train_ds.labels[:GRAPH_TRAIN])
        setting = trainer_setting(seed, out_dir, data_augment=True, augment_affine=True,
                                  data_norm=True, cutout=AUG_CUTOUT, mixup=AUG_MIXUP)
        routes = ("no_mesh", "mesh")
        trainers, loaders, calls = {}, {}, new_record()
        first = None
        for name in routes:
            model = build_model("resnet", setting, device=DEVICE)
            if first is None:
                first = model.state_dict()
            model.load_state_dict(first)
            trainers[name] = Trainer(model, mesh=mesh if name == "mesh" else None)
            trainers[name]._new_state()
            pair = [DeviceCacheLoader(ds, TRAINER_BATCH, shuffle=shuffle, seed=seed,
                                      device=DEVICE)
                    for ds, shuffle in ((train_ds, True), (valid_ds, False))]
            for loader in pair:
                loader.augment, loader.normalize = loader is pair[0], True
            loaders[name] = pair
        count_calls(trainers["mesh"], calls)
        # the all-reduces the mesh trainer's host issues: per eager step and
        # at the capture (what every replay then runs), none in a replay
        issued = []
        all_reduce = dist.all_reduce

        def counted_all_reduce(*a, **k):
            issued[-1] += 1
            return all_reduce(*a, **k)

        dist.all_reduce = counted_all_reduce
        results = {name: [] for name in routes}
        seconds = {name: [] for name in routes}
        try:
            for e in range(DP_EPOCHS):
                for name in routes if e % 2 == 0 else routes[::-1]:  # in turns
                    def epoch(name=name, e=e):
                        return trainers[name]._run_train_epoch(loaders[name][0], e)
                    issued.append(0)
                    sync()
                    t0 = time.perf_counter()
                    out = counted_run(epoch, path) if name == "mesh" else epoch()
                    seconds[name].append(time.perf_counter() - t0)
                    results[name].append(out)
                    if name == "no_mesh" and issued[-1]:
                        failures.append(f"the mesh-less fit issued {issued[-1]} all-reduces")
                    if name == "no_mesh":
                        issued.pop()
        finally:
            dist.all_reduce = all_reduce
        evals = {}
        for name in routes:
            def run_eval(name=name):
                return trainers[name]._run_eval_epoch(loaders[name][1], collect_preds=True)
            evals[name] = counted_run(run_eval, path) if name == "mesh" else run_eval()
        leaves = {name: run_leaves(trainers[name], results[name]) for name in routes}
        for name in routes:
            leaves[name]["eval/loss"] = torch.tensor(evals[name][0], dtype=torch.float64)
            leaves[name]["eval/preds"] = torch.from_numpy(np.asarray(evals[name][3]))
        unequal = [k for k in leaves["no_mesh"]
                   if not torch_equal(leaves["mesh"][k], leaves["no_mesh"][k])]
        exact = not unequal
        steps = len(loaders["mesh"][0])
        say(f"(i) RN26@32 bf16 b{TRAINER_BATCH}, {GRAPH_TRAIN} train images ({steps} steps), "
            f"phase 13's settings, {DP_EPOCHS} replayed epochs with a mesh (one rank, "
            f"{dist.get_backend()}) and without, in turns: train (loss, score) mesh "
            f"{results['mesh']}, no mesh {results['no_mesh']}; every parameter and BN buffer, "
            f"each epoch's loss and score, evaluate's loss and predictions over "
            f"{len(leaves['mesh'])} leaves bit-identical {exact} {'ok' if exact else 'FAIL'}")
        if not exact:
            gaps = leaf_gaps(leaves["mesh"], leaves["no_mesh"])
            failures.append(f"world-1 mesh fit != mesh-less fit: {unequal[:4]} "
                            f"(worst gap {max(gaps.values()):.3e})")

        model = trainers["mesh"].model
        n = conv_count(model)
        per_step = launches_of({"conv2d_stats": n, "conv2d_stats_reduce": n, "max_pool2d": 1,
                                "pool2d_backward": 1, **bn_sites(n)})
        per_eval = launches_of({"conv2d_fused": n, "max_pool2d": 1})
        replays = {g.kind: launches_summary(g.per_replay[0]) for g in graphs_of(trainers["mesh"])
                   if g.per_replay}
        ok_calls = (len(calls["train"]) == steps * DP_EPOCHS
                    and all(c == per_step for c in calls["train"])
                    and all(c == per_eval for c in calls["eval"])
                    and replays.get("train") == launches_summary(per_step))
        # one all-reduce per BN forward (the conv kernel's (2, C) row of Σy,
        # Σy², in place) and per BN backward (bn_act_backward's reduced row of
        # Σdz, Σdz·x̂, in place), one for the gradient bucket, one for Σw
        # (loss_reduction "mean")
        want_ar = 2 * n + 2
        ok_ar = issued == [(WARMUP_STEPS + 1) * want_ar] + [0] * (DP_EPOCHS - 1)
        say(f"(i) launches: {len(calls['train'])} mesh train steps each "
            f"{launches_summary(per_step)}, {len(calls['eval'])} eval batches each "
            f"{launches_summary(per_eval)} (per replay: {replays}) "
            f"{'ok' if ok_calls else 'FAIL'}; all-reduces the host issued per epoch {issued} "
            f"(want {WARMUP_STEPS} eager steps and the capture × {want_ar} = 2 × {n} BN + the "
            f"gradient bucket + Σw, then none: the replays run the captured ones) "
            f"{'ok' if ok_ar else 'FAIL'}")
        if not ok_calls:
            failures.append(f"world-1 mesh fit launches off: "
                            f"{[c for c in calls['train'] if c != per_step][:1]} {replays}")
        if not ok_ar:
            failures.append(f"world-1 mesh fit all-reduces per epoch {issued}, want "
                            f"{(WARMUP_STEPS + 1) * want_ar} then 0")

        # one more replayed epoch of the mesh trainer under the profiler: the
        # NCCL kernels the device ran (an in-place sum over one rank may run
        # none), device ms per step
        sync()
        prof, host, _, _ = profiled_epoch(lambda: counted_run(
            lambda: Trainer._run_train_epoch(trainers["mesh"], loaders["mesh"][0], DP_EPOCHS),
            path))
        device, ours, _ = device_split(prof, OUR_KERNELS)
        from torch.autograd import DeviceType

        nccl = [e for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA
                and "nccl" in e.name.lower()]
        rates = {name: [GRAPH_TRAIN / t for t in seconds[name]] for name in routes}
        say(f"(i) {card}: replayed epoch img/s with the mesh "
            f"{[round(r, 1) for r in rates['mesh']]}, without "
            f"{[round(r, 1) for r in rates['no_mesh']]} (epoch 0 holds the {WARMUP_STEPS} "
            f"eager steps and the capture); profiled mesh epoch ({steps} replays): NCCL "
            f"kernels the device ran {len(nccl)} ({len(nccl) / steps:.2f} per replay; "
            f"{sorted({e.name for e in nccl})[:3]}), device {device / 1e3 / steps:.3f} ms per "
            f"step, host {1e3 * host / steps:.3f} ms per step, the port's kernels "
            f"{ours / 1e3 / steps:.3f} ms per step")
        res.update(results=results, bit_identical=exact, img_s=rates,
                   launches_per_train_step=launches_summary(per_step), per_replay=replays,
                   all_reduces_issued=issued, all_reduces_per_step=want_ar,
                   nccl_kernels_profiled=len(nccl),
                   profiled_epoch={"host_ms_per_step": 1e3 * host / steps,
                                   "device_ms_per_step": device / 1e3 / steps,
                                   "kernels_ms_per_step": ours / 1e3 / steps})
        del trainers, loaders
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return res, path


def replicas_equal(model) -> bool:
    """Every rank's parameters and buffers equal data rank 0's, bit for bit
    (rank 0's broadcast and compared on each rank; the answer is every
    rank's)."""
    import torch
    import torch.distributed as dist

    flat = torch.cat([t.detach().float().reshape(-1) for t in model.state_dict().values()])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    same = torch.tensor([float(torch.equal(flat, ref))], device=flat.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return bool(same.item() == 1.0)


def sgd_readback(model, trainer_step, state, x, y, lr):
    """One step; returns (loss, gradients read back as (before - after) / lr,
    the BN state in the JAX layout)."""
    from convnets_tpu_torch import bridge

    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    loss, _ = trainer_step(state, x, y)
    sync()
    grads = {k: (before[k] - p.detach()) / lr for k, p in model.named_parameters()}
    return loss, grads, bridge._flatten(bridge.export_jax_variables(model)["state"])


def dp_rank(rank, world, init, payload):
    """A rank of phase 16 (ii), run by parallel.dryrun.run_ranks in a process of
    its own; writes its results to <workdir>/rank<r>.json."""
    import torch
    import torch.distributed as dist

    from convnets_tpu_torch.core.rng import generator_for
    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.parallel import init_distributed, make_mesh
    from convnets_tpu_torch.train import Trainer

    init_distributed(init, world, rank, device=DEVICE, backend=payload["backend"])
    if payload["backend"] == "nccl":  # the probe: one all-reduce over NCCL
        t = torch.ones(1, device=DEVICE)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        print(f"rank {rank}: NCCL all-reduce over {world} ranks on one card gave {t.item()}")
        dist.destroy_process_group()
        return
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.lib()
    mesh = make_mesh()
    seed, out = payload["seed"], {}

    # the fp32 global-b8 SGD step, each rank its block; rank 0 then takes
    # the same step in one process at b8, the perturbed control, and the
    # no-sync control (its half alone through the plain BN)
    lr = 2.0 ** 20
    rng = np.random.default_rng(seed + 2)
    xg = torch.from_numpy(rng.integers(0, 256, (DP_CHECK_BATCH, IMAGE, IMAGE, 3),
                                       dtype=np.uint8)).to(DEVICE)
    yg = torch.from_numpy(rng.integers(0, 1000, DP_CHECK_BATCH)).to(DEVICE)
    k = DP_CHECK_BATCH // world

    weights = {}

    def sgd(mesh_=None, perturb=False):
        # the numpy draw of RN50's weights once; every later model copies them
        from convnets_tpu_torch.models import build_model

        kw = dict(dropout_rate=0.0, optimizer="sgd", learning_rate=lr, momentum=0.0,
                  weight_decay=0.0)
        if not weights:
            model = make_model("resnet", seed, False, **kw)
            weights.update({k: t.clone() for k, t in model.state_dict().items()})
        else:
            model = build_model("resnet", model_setting("resnet", seed, False, **kw),
                                device=DEVICE)
            model.load_state_dict(weights)
        if perturb:
            gen = torch.Generator(device=DEVICE).manual_seed(seed)
            with torch.no_grad():
                for p in model.parameters():
                    if p.ndim == 4:
                        p.mul_(1 + CONTROL_PERTURBATION * torch.randn(p.shape, device=DEVICE,
                                                                      generator=gen))
        trainer = Trainer(model, mesh=mesh_)
        trainer._new_state()
        return model, trainer, trainer._get_train_step(augment=False, norm=False)

    model, trainer, step = sgd(mesh)
    loss, grads, bn = sgd_readback(model, step, trainer.state, xg[rank * k:(rank + 1) * k],
                                   yg[rank * k:(rank + 1) * k], lr)
    dist.all_reduce(loss)
    out["sgd_replicas_equal"] = replicas_equal(model)
    del model, trainer, step
    if rank == 0:
        runs = {}
        for name, perturb, rows, plain in (("one", False, DP_CHECK_BATCH, False),
                                           ("control", True, DP_CHECK_BATCH, False),
                                           ("half", False, k, True)):
            m, t, s = sgd(perturb=perturb)
            with plain_kernels() if plain else contextlib.nullcontext():
                runs[name] = sgd_readback(m, s, t.state, xg[:rows], yg[:rows], lr)
            del m, t, s
        lo, go, so = runs["one"]
        gaps = {n: l2_err(grads[n], go[n]) for n in go}
        cgaps = sorted(l2_err(runs["control"][1][n], go[n]) for n in go)

        def bn_rel(s):
            return max(float(np.abs(s[n] - so[n]).max() / max(np.abs(so[n]).max(), 1e-30))
                       for n in so)

        worst = max(gaps, key=gaps.get)
        out["sgd"] = {"loss_rel": abs(float(loss) - float(lo)) / abs(float(lo)),
                      "loss": float(loss), "loss_one": float(lo),
                      "worst_grad_l2": gaps[worst], "worst_leaf": worst,
                      "median_grad_l2": float(np.median(list(gaps.values()))),
                      "control_max_grad_l2": cgaps[-1],
                      "control_median_grad_l2": cgaps[len(cgaps) // 2],
                      "bn_rel": bn_rel(bn), "half_bn_rel": bn_rel(runs["half"][2]),
                      "finite": all(bool(torch.isfinite(g).all()) for g in grads.values())}
        del runs
    torch.cuda.empty_cache()
    dist.barrier()

    # bench.py's step in bf16 at DP_RANK_BATCH per rank: launches per step,
    # replicas after every step, the global loss, the timed steps
    model = make_model("resnet", seed, True, learning_rate=LEARN_LR["resnet"])
    trainer = Trainer(model, mesh=mesh)
    trainer._new_state()
    step = trainer._get_train_step(augment=False, norm=False)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    n = DP_RANK_BATCH
    x = torch.randint(0, 256, (n * world, IMAGE, IMAGE, 3), dtype=torch.uint8, device=DEVICE,
                      generator=gen)[rank * n:(rank + 1) * n]
    y = torch.randint(0, 1000, (n * world,), device=DEVICE, generator=gen)[rank * n:(rank + 1) * n]
    want = launches_of(TRAIN_LAUNCHES["resnet"])
    steps = []
    for s in range(DP_LEARN_STEPS):
        kernels.reset_launches()
        sync()
        t0 = time.perf_counter()
        loss, _ = step(trainer.state, x, y, None,
                       generator_for(seed, "dropout", 0, s, rank, device=DEVICE))
        sync()
        seconds = time.perf_counter() - t0
        launches_ok = dict(kernels.LAUNCHES) == want
        dist.all_reduce(loss)
        steps.append({"seconds": seconds, "loss": float(loss), "launches_ok": launches_ok,
                      "launches": launches_summary(dict(kernels.LAUNCHES)),
                      "replicas_equal": replicas_equal(model)})
    out["bf16"] = {"steps": steps, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    with open(os.path.join(payload["workdir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def dp_nccl_probe(seed, out_dir) -> str:
    """Phase 16 (ii)'s probe: two ranks on the one card over NCCL, one
    all-reduce; what happened, in a line."""
    from convnets_tpu_torch.parallel.dryrun import run_ranks

    probe = os.path.join(out_dir, "probe")
    os.makedirs(probe)
    try:
        outs = run_ranks("chip_smoke:dp_rank", 2, {"backend": "nccl", "seed": seed,
                                                  "workdir": probe},
                         workdir=probe, timeout=DP_PROBE_TIMEOUT, paths=[HERE])
        return "ran: " + " | ".join(o.strip()[-200:] for o in outs)
    except (RuntimeError, TimeoutError) as e:
        lines = [ln for ln in str(e).splitlines() if "rror" in ln or "uplicate" in ln]
        return "refused: " + " | ".join(lines[-3:])[-600:]


def dp_two_ranks(seed, out_dir, card, failures):
    """Phase 16 (ii): two gloo ranks on the card."""
    from convnets_tpu_torch.parallel.dryrun import run_ranks

    res = {}
    work = os.path.join(out_dir, "ranks")
    os.makedirs(work)
    t0 = time.perf_counter()
    try:
        run_ranks("chip_smoke:dp_rank", 2, {"backend": "gloo", "seed": seed, "workdir": work},
                  workdir=work, timeout=DP_TIMEOUT, paths=[HERE], threads=4)
    except (RuntimeError, TimeoutError) as e:
        failures.append(f"two gloo ranks on the card: {str(e)[-3000:]}")
        say(f"(ii) two gloo ranks FAIL: {str(e)[-3000:]}")
        return res
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    sgd = ranks[0]["sgd"]
    ok_sgd = (sgd["loss_rel"] <= 1e-4 and sgd["worst_grad_l2"] <= STEP_GRAD_TOL
              and sgd["bn_rel"] <= 1e-4 and sgd["finite"]
              and all(r["sgd_replicas_equal"] for r in ranks))
    ok_half = sgd["half_bn_rel"] > 1e-4
    say(f"(ii) fp32 SGD step, global b{DP_CHECK_BATCH} on 2 gloo ranks ({DP_CHECK_BATCH // 2} "
        f"each) vs one process at b{DP_CHECK_BATCH}: loss {sgd['loss']:.6f} vs "
        f"{sgd['loss_one']:.6f} (rel {sgd['loss_rel']:.2e}, tol 1e-4); worst ‖Δ‖/‖g‖ "
        f"{sgd['worst_grad_l2']:.2e} at {sgd['worst_leaf']} (median "
        f"{sgd['median_grad_l2']:.2e}; tol {STEP_GRAD_TOL:g}; control, conv weights ×(1 + "
        f"{CONTROL_PERTURBATION:g}·N(0,1)): median {sgd['control_median_grad_l2']:.2e} max "
        f"{sgd['control_max_grad_l2']:.2e}); BN running stats rel {sgd['bn_rel']:.2e} (tol "
        f"1e-4); replicas bit-identical {[r['sgd_replicas_equal'] for r in ranks]} "
        f"{'ok' if ok_sgd else 'FAIL'}\n    no-sync control, rank 0's half alone through "
        f"the plain BN: running stats rel {sgd['half_bn_rel']:.2e}, outside 1e-4: "
        f"{'ok' if ok_half else 'FAIL'}")
    if not ok_sgd:
        failures.append(f"2-rank fp32 SGD step vs one process: {sgd}")
    if not ok_half:
        failures.append(f"the no-sync control is inside the bar: {sgd['half_bn_rel']:.2e}")
    steps = [r["bf16"]["steps"] for r in ranks]
    ok_launch = all(s["launches_ok"] for st in steps for s in st)
    ok_equal = all(s["replicas_equal"] for st in steps for s in st)
    losses = [s["loss"] for s in steps[0]]
    ok_learn = all(np.isfinite(losses)) and losses[-1] < losses[0]
    timed = [max(steps[r][i]["seconds"] for r in range(2))
             for i in range(DP_DEPTH[0], sum(DP_DEPTH))]
    rate = 2 * DP_RANK_BATCH / float(np.mean(timed))
    say(f"(ii) RN50@224 bf16, bench.py's settings (Adam lr {LEARN_LR['resnet']:g}, wd 1e-4, "
        f"dropout 0.5), global b{2 * DP_RANK_BATCH} on 2 gloo ranks sharing the card: "
        f"{DP_LEARN_STEPS} steps, each rank's launches per step "
        f"{steps[0][0]['launches']} every step {'ok' if ok_launch else 'FAIL'}; replicas "
        f"bit-identical after every step {'ok' if ok_equal else 'FAIL'}; global loss "
        f"{[round(v, 4) for v in losses]} {'falls, ok' if ok_learn else 'FAIL'}")
    say(f"(ii) {card}: a gloo-on-one-card rate, not a DDP rate: {rate:.1f} img/s over steps "
        f"{DP_DEPTH[0]}-{sum(DP_DEPTH) - 1} ({[round(1e3 * t, 1) for t in timed]} ms, the "
        f"slower rank's); peak memory per rank "
        f"{[round(r['bf16']['peak_gib'], 2) for r in ranks]} GiB; ranks' wall {wall:.1f} s")
    if not ok_launch:
        bad = [s["launches"] for st in steps for s in st if not s["launches_ok"]]
        failures.append(f"2-rank RN50 launches per step off: {bad[:2]}")
    if not ok_equal:
        failures.append("2-rank RN50: the replicas differ after a step")
    if not ok_learn:
        failures.append(f"2-rank RN50 bf16 loss does not fall: {losses}")
    res.update(sgd=sgd, gloo_img_s=rate, timed_ms=[1e3 * t for t in timed], losses=losses,
               launches_per_step=steps[0][0]["launches"])
    return res


def dp_torchrun_cli(seed, out_dir, card, failures):
    """Phase 16 (iii): `torchrun --nproc-per-node 1 -m convnets_tpu_torch fit` on
    phase 12's PNG tree, recorded from inside by DP_SITE; then the same
    checkpoint's Trainer.test in this process."""
    from convnets_tpu_torch.data.manager import DataMngr
    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.settings import Settings
    from convnets_tpu_torch.train import Trainer
    from convnets_tpu_torch.train import checkpoint as ckpt

    root = cli_tree(seed)
    site = os.path.join(out_dir, "site")
    os.makedirs(site)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(DP_SITE)
    record = os.path.join(out_dir, "cli_record.json")
    run_dir = os.path.join(out_dir, "cli_fit")
    test_batches = -(-CLI_SPLITS[2][1] // CLI_BATCH)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [site, HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        "CHIP_SMOKE_RECORD": record, "CHIP_SMOKE_HERE": HERE,
        "CHIP_SMOKE_TEST_BATCHES": str(test_batches)}
    # torchrun is torch.distributed.run's console script; the module is the
    # same program, found whether or not the script is on PATH
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "1", "-m", "convnets_tpu_torch", "fit", "--arch", "resnet", "--kind", "26",
           "--batch-size", str(CLI_BATCH), "--epochs", str(DP_CLI_EPOCHS), "--input-size",
           "3,32,32", "--num-classes", str(ZOO_CLASSES), "--data-root", root, "--seed",
           str(seed), "--output-dir", run_dir]
    t0 = time.perf_counter()
    proc = finished(subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True), DP_TIMEOUT)
    wall = time.perf_counter() - t0
    written = [f for f in os.listdir(run_dir) if f.endswith(ckpt.EXT)] \
        if os.path.isdir(run_dir) else []
    rec = {}
    if os.path.exists(record):
        with open(record) as f:
            rec = json.load(f)
    ok_exit = proc.returncode == 0 and len(written) == 1 and rec.get("mesh") \
        and rec.get("world") == 1
    say(f"(iii) torchrun --nproc-per-node 1 -m convnets_tpu_torch fit RN26@32 (b{CLI_BATCH}, "
        f"{DP_CLI_EPOCHS} epoch, {CLI_SPLITS[0][1]} train PNGs): exit {proc.returncode} in "
        f"{wall:.1f} s, checkpoints {written}, the Trainer's mesh {rec.get('mesh')} over "
        f"{rec.get('world')} rank {'ok' if ok_exit else 'FAIL'}")
    if not ok_exit:
        failures.append(f"torchrun CLI fit: exit {proc.returncode}, files {written}, record "
                        f"{bool(rec)}: {proc.stderr[-3000:]}")
        return {"exit": proc.returncode}
    rec_calls = {"train": rec["train"], "eval": rec["eval"]}
    check_calls("torchrun CLI", rec_calls, rec["per_step"], rec["per_eval"], failures)
    # the same checkpoint's Trainer.test in this process, no mesh
    trainer = Trainer(build_model("resnet", Settings(
        kind="26", input_size=(3, 32, 32), num_classes=ZOO_CLASSES, batch_size=CLI_BATCH,
        seed=seed, output_dir=run_dir), device=DEVICE))
    trainer.load_checkpoint(os.path.join(run_dir, written[0]))
    mine = new_record()
    mine["capture"] = True
    count_calls(trainer, mine)
    trainer.test(DataMngr(trainer.setting, root=root, device=DEVICE).load_test())
    here = sum((p[w > 0].tolist() for _, p, w in mine["eval_io"][-test_batches:]), [])
    agree = here == rec["test_preds"] and len(here) == CLI_SPLITS[2][1]
    say(f"    its test argmax over the {len(here)} test images = an in-process Trainer.test of "
        f"the same checkpoint: {agree} {'ok' if agree else 'FAIL'}; epoch seconds "
        f"{[round(s, 2) for s in rec['epoch_s']]} ({card})")
    if not agree:
        failures.append("torchrun CLI: test argmax differs from the in-process Trainer.test")
    return {"exit": proc.returncode, "checkpoints": written, "argmax_equal": agree,
            "epoch_s": rec["epoch_s"], "wall_s": wall}


def dp_dryrun() -> tuple:
    """Phase 16 (iv): (rank 0's line or the error, whether it is OK)."""
    from convnets_tpu_torch.parallel.dryrun import dryrun_multichip

    try:
        line = dryrun_multichip(2, DEVICE, timeout=DP_TIMEOUT)
        return line, line.endswith("OK")
    except (RuntimeError, TimeoutError) as e:
        return str(e)[-2000:], False


def phase_data_parallel(seed, card, failures):
    """Phase 16: (i)-(iv); (i) and (ii)'s gloo ranks alone on the card (they
    are timed), then the untimed runs started together: (ii)'s NCCL probe,
    (iii) and (iv). Prints the data_parallel JSON line; returns the
    launches of (i)'s mesh fit."""
    from concurrent.futures import ThreadPoolExecutor

    out, parts = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out["world_one"], path = dp_world_one(seed, tmp, card, failures)
        parts["i"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["two_ranks"] = dp_two_ranks(seed, tmp, card, failures)
        parts["ii"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            probe, dry = pool.submit(dp_nccl_probe, seed, tmp), pool.submit(dp_dryrun)
            out["torchrun"] = dp_torchrun_cli(seed, tmp, card, failures)
            out["two_ranks"]["nccl_two_ranks_one_card"] = probe.result()
            line, ok = dry.result()
        parts["ii_probe_iii_iv"] = time.perf_counter() - t0
    say(f"(ii) NCCL with two ranks on one card: {out['two_ranks']['nccl_two_ranks_one_card']}")
    say(f"(iv) {line} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"dryrun_multichip(2, 'cuda'): {line}")
    out["dryrun"] = line
    out["seconds"] = parts
    say(json.dumps({"data_parallel": {"card": card, **out}}, default=str))
    return path_entries(path)


# phase 17: every conv the JAX package's Conv2d accepts (ROADMAP item 8's
# four kinds: more than 64 groups, a stride of 3 or different strides per
# axis, a depthwise channel multiplier, a dilated depthwise conv). (i): the
# kernels at these shapes on their planned routes, b8 both dtypes and b256
# bf16 (timed beside cuDNN and the bound); (ii): a network built as
# template_net.py shows, one of each kind, trained, served and exported.
# depthwise: (what, (H, W, Cin, Cout, k, stride, pad, dilation))
ENVELOPE_DEPTHWISE = (
    ("D1 dilated, DeepLabv3+ MobileNetV2 os16", (33, 33, 576, 576, 3, 1, 2, 2)),
    ("D1 dilated, DeepLabv3+ MobileNetV2 os16", (33, 33, 960, 960, 3, 1, 2, 2)),
    ("D2 multiplier 2", (112, 112, 32, 64, 3, 1, 1, 1)),
    ("D2 multiplier 2", (28, 28, 256, 512, 3, 2, 1, 1)),
    ("D3 dilated, multiplier 2", (28, 28, 64, 128, 3, 1, 2, 2)),
    ("D4 dilated, stride 2", (33, 33, 576, 576, 3, 2, 2, 2)),  # the vector route's S=2, D=2
)
# grouped: (what, (H, W, Cin, Cout, k, stride, pad, dilation, groups))
ENVELOPE_GROUPED = (
    ("G1 128 groups", (14, 14, 1024, 1024, 3, 1, 1, 1, 128)),
    ("G1 128 groups", (14, 14, 1024, 1024, 3, 2, 1, 1, 128)),
    ("G2 256 groups, Cin/G 2", (28, 28, 512, 512, 3, 1, 1, 1, 256)),
    ("G3 1x1, 128 groups", (14, 14, 1024, 2048, 1, 1, 0, 1, 128)),
    ("G4 stride 3", (30, 30, 256, 256, 3, 3, 1, 1, 32)),
    ("G4 stride (2, 1)", (28, 28, 128, 128, 3, (2, 1), 1, 1, 32)),
)
# the route each kind's plan must give in bf16 (fp32: the grouped ones on
# "simt"; a depthwise route does not depend on the dtype)
ENVELOPE_ROUTES = {"D1": "vector", "D2": "loop", "D3": "loop", "D4": "vector", "G1": "wgmma",
                   "G2": "simt", "G3": "wgmma_wide", "G4": "wgmma"}
# the b256 bf16 calls' sums on rows 1g, 5g and 9: kernel ms, cuDNN's
# F.conv2d ms, bound, and the other route on the same inputs (grouped: the
# CUDA-core loop; depthwise D1: the loop route)
ENVELOPE_KEYS = ("envelope_ms_b256", "envelope_library_ms_b256", "envelope_bound_ms_b256",
                 "envelope_other_route_ms_b256")
ENVELOPE_NET = "envelope_net"  # (ii): registered for this phase only
ENVELOPE_PATH_BATCH = 256  # (ii): the path's bf16 train step and served request


def envelope_dw_check(label, n, shape, dtype, g, summary, failures, times=False):
    """One depthwise shape on the card: depthwise_conv2d against
    depthwise_conv2d_plain (CONV_TOL), the launch counted on the route
    depthwise_plan gives (which must be the kind's, ENVELOPE_ROUTES), and on
    the vector route bit for bit against the loop route (torch.equal).
    times: the b256 bf16 ms of the kernel, of the loop route for a vector
    plan, of the plain version and of cuDNN's F.conv2d with the same
    stride, dilation and groups, and the bound (x and w read, y written),
    added to row 9's ENVELOPE_KEYS. Returns the record."""
    import torch
    import torch.nn.functional as F

    from convnets_tpu_torch.ops import kernels

    h, w, cin, cout, k, s, p, d = shape
    dname = dname_of(dtype)
    atol, rtol = CONV_TOL[dname]
    x = torch.randn(n, h, w, cin, device=DEVICE, generator=g).to(dtype)
    wt = (torch.randn(k, k, 1, cout, device=DEVICE, generator=g) / k).to(dtype)
    kw = dict(stride=s, padding=p, dilation=d)
    plan = kernels.depthwise_plan(n, h, w, cin, k, k, s, p, dtype, dilation=d,
                                  multiplier=cout // cin)
    want = ENVELOPE_ROUTES[label[:2]]
    kernels.reset_launches()
    got = kernels.depthwise_conv2d(x, wt, **kw)
    routes = dict(kernels.ROUTE_LAUNCHES["depthwise_conv2d"])
    ref = kernels.depthwise_conv2d_plain(x, wt, **kw)
    sync()
    err = float((got.float() - ref.float()).abs().max())
    same = (torch.equal(got, kernels.depthwise_conv2d(x, wt, **kw, route="loop"))
            if plan.route == "vector" else None)
    ok = (within(got, ref, atol, rtol) and bool(torch.isfinite(got).all())
          and plan.route == want and routes == {"vector": 0, "loop": 0, plan.route: 1}
          and same is not False)
    rec = {"what": label, "n": n, "shape": list(shape), "dtype": dname, "route": plan.route,
           "err": err, "vector_equals_loop": same, "ok": bool(ok)}
    row = entry(summary, "depthwise_conv2d")
    row["err"] = max(row["err"], err)
    text = ""
    if times:
        xc, wc = nchw(x), oihw(wt)
        k_ms = time_ms(lambda: kernels.depthwise_conv2d(x, wt, **kw), REPS)
        l_ms = (time_ms(lambda: kernels.depthwise_conv2d(x, wt, **kw, route="loop"), REPS)
                if plan.route == "vector" else k_ms)
        p_ms = time_ms(lambda: kernels.depthwise_conv2d_plain(x, wt, **kw), REPS)
        c_ms = time_ms(lambda: F.conv2d(xc, wc, stride=s, padding=p, dilation=d, groups=cin),
                       REPS)
        flops, nbytes = conv_work(n, h, w, cin, cout, k, s, p, cin, dilation=d)
        bound = 1e3 * max(flops / PEAK_OTHER, nbytes / HBM_BPS)
        for key, v in zip(ENVELOPE_KEYS, (k_ms, c_ms, bound, l_ms)):
            row[key] = row.get(key, 0.0) + v
        rec.update(ms=k_ms, loop_ms=l_ms, plain_ms=p_ms, cudnn_ms=c_ms, bound_ms=bound)
        text = (f" | {k_ms:.4f} loop {l_ms:.4f} plain {p_ms:.4f} cuDNN {c_ms:.4f} bound "
                f"{bound:.4f} ({100 * bound / k_ms:.1f}%)")
    say(f"  {label} | {n} {' '.join(map(str, shape))} | {dname} {plan.route} (want {want}) "
        f"{routes} | {err:.3e} ({atol:g}+{rtol:g}|ref|) | vector == loop {same} "
        f"{'ok' if ok else 'FAIL'}{text}")
    if not ok:
        failures.append(f"envelope {label} {n}x{shape} {dname}: route {plan.route} (want "
                        f"{want}, launches {routes}), err {err:.3e}, vector == loop {same}")
    del x, wt, got, ref
    return rec


def envelope_kernels(summary, failures):
    """Phase 17 (i): every shape of ENVELOPE_DEPTHWISE and ENVELOPE_GROUPED
    at b8 in fp32 and bf16 and at b256 in bf16 (timed) against its plain
    version, each call on the route its plan gives (counted; the grouped
    ones through zoo2_conv_check, both epilogues and the statistics
    kernel); then each trainable function at one new shape, forward and
    gradients against the plain path. Returns the records."""
    import torch

    from convnets_tpu_torch.ops import kernels

    g = torch.Generator(device=DEVICE).manual_seed(17)
    f32, bf16 = torch.float32, torch.bfloat16
    runs = ((KERNEL_BATCH, f32, False), (KERNEL_BATCH, bf16, False), (B256, bf16, True))
    say(f"(i) depthwise: what | N H W Cin Cout k s p d | dtype route (want) launches per route | "
        f"max|Δ| (tol) | vector == loop | at b{B256} bf16: kernel ms, loop route, plain, cuDNN, "
        f"bound (share)")
    records = [envelope_dw_check(label, n, shape, dtype, g, summary, failures, timed)
               for label, shape in ENVELOPE_DEPTHWISE for n, dtype, timed in runs]
    say(f"(i) grouped: what | N H W Cin Cout k s p d G | dtype route (want) | fused y err "
        f"relu=0 / 1 (tol) | stats y err, Σ rel, Σ² rel | at b{B256} bf16: fused ms, stats ms, "
        f"cuDNN ms, bound ms | the CUDA-core loop's (simt plans: the tensor-core route's)")
    for label, shape in ENVELOPE_GROUPED:
        for n, dtype, timed in runs:
            rec = zoo2_conv_check(label, n, shape, dtype, g, summary, failures,
                                  ENVELOPE_KEYS if timed else False)
            want = ENVELOPE_ROUTES[label[:2]] if dtype == bf16 else "simt"
            if rec["route"] != want:
                rec["ok"] = False
                failures.append(f"envelope {label} {dname_of(dtype)}: route {rec['route']}, "
                                f"want {want}")
            records.append(rec)
    for kind in ENVELOPE_ROUTES:
        timed = [r for r in records if r["what"].startswith(kind) and "cudnn_ms" in r]
        ms = sum(r.get("fused_ms", r.get("ms", 0.0)) for r in timed)
        say(f"(i) b{B256} bf16, {kind} ({len(timed)} shapes): kernel {ms:.4f} ms, cuDNN "
            f"{sum(r['cudnn_ms'] for r in timed):.4f} ms, bound "
            f"{sum(r['bound_ms'] for r in timed):.4f} ms ({timed[0]['route']} route)")

    say("(i) train functions at one new shape each: fn label | dtype | out max|Δ|/max|ref| (tol) "
        "| gradients ‖Δ‖/‖g‖ (tol) [max|Δ|/max|g|] | ReLU mask flips | fwd+bwd kernel_ms "
        "plain_ms library_ms")
    shapes = dict(ENVELOPE_GROUPED)
    dw = dict(ENVELOPE_DEPTHWISE)
    trains = (("depthwise_train", dw["D3 dilated, multiplier 2"] + (64,)),
              ("grouped_conv2d_train", ENVELOPE_GROUPED[1][1]),
              ("conv_bn_relu_train_grouped", shapes["G4 stride (2, 1)"]),
              ("conv_bn_relu_train_grouped", shapes["G2 256 groups, Cin/G 2"]))
    for name, (h, w, cin, cout, k, s, p, d, groups) in trains:
        cg = cin // groups
        x32 = torch.randn(KERNEL_BATCH, h, w, cin, device=DEVICE, generator=g)
        w32 = torch.randn(k, k, cg, cout, device=DEVICE, generator=g) / np.sqrt(k * k * cg)
        sc = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        bi = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        work = conv_train_work(KERNEL_BATCH, h, w, cin, cout, k, s, p, groups, d)
        label = f"{h} {cin} {cout} k{k} s{s} p{p} d{d} G{groups}"
        for dtype in (f32, bf16):
            dname = dname_of(dtype)
            x, wt = x32.to(dtype), w32.to(dtype)
            if name == "conv_bn_relu_train_grouped":
                check_trainable(name, label, lambda a, b, c_, e: kernels.conv_bn_relu_train(
                    a, b, c_, e, s, p, groups=groups, dilation=d)[0], [x, wt, sc, bi], dname, g,
                    summary, failures, CONV_TOL[dname][1], work)
            elif name == "grouped_conv2d_train":
                check_trainable(name, label, lambda a, b: kernels.grouped_conv2d_train(
                    a, b, groups, s, p, d), [x, wt], dname, g, summary, failures,
                    CONV_TOL[dname][1], work, conv_lib(s, p, groups, d))
            else:
                check_trainable(name, label, lambda a, b: kernels.depthwise_train(a, b, s, p, d),
                                [x, wt], dname, g, summary, failures, CONV_TOL[dname][1], work,
                                conv_lib(s, p, groups, d))
    return records


def build_envelope_net(setting):
    """The network a user who copies template_net.py would write with the
    convs of ROADMAP item 8: Builder.conv_block layers, a BN site on each,
    one of each kind at 3x32x32, each on its planned route in bf16 (D2 and
    D3 loop, D1 vector; the grouped mode for the G4s and G1, the CUDA-core
    loop for G2, the wide tensor-core route for G3).
    tests/test_torch_conv_full_envelope.py holds a narrower one against
    its JAX twin."""
    from convnets_tpu_torch import nn
    from convnets_tpu_torch.models.base import Builder, Model

    b = Builder(setting)
    layers = [
        b.conv_block(64, kernel=3, padding=1),                              # dense stem
        b.conv_block(128, kernel=3, padding=1, groups=64),                  # D2: multiplier 2
        b.conv_block(128, kernel=3, padding=2, dilation=2, groups=128),     # D1: dilated
        b.conv_block(256, kernel=3, padding=2, dilation=2, groups=128),     # D3: both
        b.conv_block(256, kernel=3, stride=(2, 1), padding=1, groups=64),   # G4: per-axis stride
        b.conv_block(256, kernel=3, stride=3, padding=1, groups=64),        # G4: stride 3
        b.conv_block(1024, kernel=1),                                       # dense 1x1
        b.conv_block(1024, kernel=3, stride=2, padding=1, groups=128),      # G1: 128 groups
        b.conv_block(1024, kernel=3, padding=1, groups=512),                # G2: Cin/G 2
        b.conv_block(2048, kernel=1, groups=128),                           # G3: 1x1
        nn.GlobalAvgPool2d(),
        b.linear(setting.num_classes)]
    return Model("EnvelopeNet", setting, nn.Sequential(layers))


@contextlib.contextmanager
def registered(name, build):
    """`build` in the port's registry under `name` for the duration, as a
    copied template_net.py registers its net."""
    from convnets_tpu_torch.models import base

    base._REGISTRY[name] = build
    try:
        yield
    finally:
        base._REGISTRY.pop(name, None)


def window_routes_want(model, n):
    """The depthwise launches per route of one bf16 forward of the model at
    batch n, read off its depthwise convs (model_layers) through
    depthwise_plan."""
    import torch

    from convnets_tpu_torch.ops import kernels

    want = {"vector": 0, "loop": 0}
    for kind, h, w, cin, cout, k, s, p, _, g, d in model_layers(model, with_dilation=True):
        if kind in ("dwconv", "plaindwconv"):
            want[kernels.depthwise_plan(n, h, w, cin, k, k, s, p, torch.bfloat16, dilation=d,
                                        multiplier=cout // cin).route] += 1
    return want


def envelope_path(seed, failures):
    """Phase 17 (ii)'s path: one bf16 Adam step of the network at b256 and
    one served b256 uint8 request, the counts set to 0 just before each and
    read just after each; the step held to a step's launches read off the
    model (model_launches) and the request to a forward's, each per route to
    grouped_routes_want and depthwise_plan. Returns the path's launches per
    kernels-line entry (depthwise_train: the step's own depthwise_conv2d
    launches)."""
    import torch

    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.serve import ServingModel

    n = ENVELOPE_PATH_BATCH
    model = zoo_model(ENVELOPE_NET, "0", 32, seed)
    want_fwd, want_step = model_launches(model)
    fwd_routes, step_routes = grouped_routes_want(model)
    state, step = train_state(model, norm=True, stats=IMAGENET_STATS)
    rng = np.random.default_rng(seed + 17)
    x = torch.from_numpy(rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)).to(DEVICE)
    y = torch.from_numpy(rng.integers(0, ZOO_CLASSES, n)).to(DEVICE)
    req = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    step(state, x, y)  # the first step builds the kernels' plans and cuDNN's backward
    model.eval()
    server = ServingModel(model, input_dtype="uint8", stats=IMAGENET_STATS)
    server(req)
    model.train()
    dw_want = window_routes_want(model, n)

    def counted():
        return dict(kernels.LAUNCHES), {**grouped_routes(), "depthwise_conv2d": dict(
            kernels.ROUTE_LAUNCHES["depthwise_conv2d"])}

    sync()
    kernels.reset_launches()
    loss = float(step(state, x, y)[0])
    sync()
    got_step, routes_step = counted()
    model.eval()
    kernels.reset_launches()
    logits = server(req)
    sync()
    got_fwd, routes_fwd = counted()
    finite = np.isfinite(loss) and bool(torch.isfinite(logits).all())
    say(f"(ii) the path's step loss {loss:.4f}, request logits finite: "
        f"{'ok' if finite else 'FAIL'}")
    if not finite:
        failures.append(f"envelope path: loss {loss}, logits finite "
                        f"{bool(torch.isfinite(logits).all())}")
    for what, got, want, routes, want_routes in (
            ("step", got_step, want_step, routes_step, step_routes),
            ("request", got_fwd, want_fwd, routes_fwd, fwd_routes)):
        want_routes = {**want_routes, "depthwise_conv2d": dw_want}
        fine = got == want and routes == want_routes
        say(f"(ii) the path's {what} at b{n} (bf16 Adam step / served uint8 request): launches "
            f"{launches_summary(got)} (expected {launches_summary(want)}); per route {routes} "
            f"(expected {want_routes}) {'ok' if fine else 'FAIL'}")
        if not fine:
            failures.append(f"envelope path {what}: launches {got}, routes {routes}")
    del model, state, server
    got = {k: got_step.get(k, 0) + got_fwd.get(k, 0) for k in set(got_step) | set(got_fwd)}
    return {"conv2d_fused": got["conv2d_fused"], "grouped_conv2d_fused": got["grouped_conv2d_fused"],
            "depthwise_conv2d": got["depthwise_conv2d"], "conv2d_stats": got["conv2d_stats"],
            "conv2d_stats_reduce": got["conv2d_stats_reduce"],
            "grouped_conv2d_stats": got["grouped_conv2d_stats"],
            "bn_act_forward": got["bn_act_forward"],
            "bn_act_backward": got["bn_act_backward_apply"],
            "conv_bn_relu_train": got["conv2d_stats"],
            "conv_bn_relu_train_grouped": got["grouped_conv2d_stats"],
            "depthwise_train": got_step["depthwise_conv2d"]}


def envelope_artifact(seed, failures):
    """Phase 17 (iii): the network exported (bf16, uint8 wire, symbolic
    batch) and served by a fresh process (CHILD: no convnets_tpu_torch.models,
    no jax), its argmax and logits against the live ServingModel's on the
    same 8 images (the logits within the bf16 conv bar) and its launches
    against a forward's. Returns the record."""
    import torch

    from convnets_tpu_torch.serve import ServingModel, save_artifact

    model = zoo_model(ENVELOPE_NET, "0", 32, seed)
    want = launches_summary(model_launches(model)[0])
    x = np.random.default_rng(seed).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    live = ServingModel(model, input_dtype="uint8", stats=IMAGENET_STATS)(x)
    sync()
    with tempfile.TemporaryDirectory() as out_dir:
        path = os.path.join(out_dir, "envelope_net.bin")
        t0 = time.perf_counter()
        save_artifact(path, model, input_dtype="uint8", stats=IMAGENET_STATS)
        export_s = time.perf_counter() - t0
        proc = subprocess.run([sys.executable, "-c", CHILD, HERE, path, str(seed), "32"],
                              capture_output=True, text=True, timeout=600)
    rec = {"export_s": export_s, "child_rc": proc.returncode}
    ok = proc.returncode == 0
    if ok:
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        agree = float(np.mean(np.array(child["argmax"]) == live.argmax(-1).cpu().numpy()))
        ref = live.float().cpu().numpy()
        rel = float(np.abs(np.array(child["logits"]) - ref).max() / np.abs(ref).max())
        ok = (agree >= ARGMAX_MIN and rel <= CONV_TOL["bfloat16"][1] and child["finite"]
              and child["launches"] == want and not child["models_imported"]
              and not child["jax_imported"])
        rec.update(argmax_agreement=agree, logits_rel=rel, launches=child["launches"])
        say(f"(iii) the artifact (exported in {export_s:.1f} s) served by a fresh process: "
            f"argmax agreement with the live model {agree:.4f} (min {ARGMAX_MIN}), logits max "
            f"|Δ| / max |logit| {rel:.3e} (tol {CONV_TOL['bfloat16'][1]:g}), launches "
            f"{child['launches']} (expected {want}), models imported "
            f"{child['models_imported']}, jax imported {child['jax_imported']} "
            f"{'ok' if ok else 'FAIL'}")
    else:
        say(f"(iii) the fresh process failed ({proc.returncode}): {proc.stderr[-2000:]}")
    if not ok:
        failures.append(f"envelope artifact: {rec}")
    del model
    return rec


def phase_envelope(seed, card, summary, failures):
    """Phase 17: (i) envelope_kernels; (ii) the network of
    build_envelope_net through zoo_family (fp32 b8 eval logits and SGD step
    against the plain path, ten bf16 Adam steps with a falling loss,
    launches per forward and step, the b256 request against the plain
    path), a profiled b256 request with exact launches and no library
    convolution kernel, and envelope_path; (iii) envelope_artifact. Prints
    the envelope JSON line; returns the path's launches."""
    import torch

    from convnets_tpu_torch.ops import kernels

    out, parts = {"card": card}, {}
    t0 = time.perf_counter()
    records = envelope_kernels(summary, failures)
    out["kernels"] = {"calls": len(records), "ok": sum(r["ok"] for r in records),
                      "b256": [{k: r[k] for k in ("what", "shape", "route", "fused_ms", "stats_ms",
                                                  "ms", "loop_ms", "simt_fused_ms",
                                                  "wide_fused_ms", "cudnn_ms", "bound_ms")
                                if k in r} for r in records if "cudnn_ms" in r]}
    parts["i"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with registered(ENVELOPE_NET, build_envelope_net):
        res, model32 = zoo_family(ENVELOPE_NET, "0", 32, seed, card, failures)
        del model32
        out["model"] = res
        model = zoo_model(ENVELOPE_NET, "0", 32, seed)
        launches, names, share = served_no_library_conv(f"{ENVELOPE_NET}@32", model, 32, seed,
                                                         failures)
        routes = dict(kernels.ROUTE_LAUNCHES["depthwise_conv2d"])
        want, want_dw = model_launches(model)[0], window_routes_want(model, ZOO_SERVE_BATCH)
        ok = launches == want and routes == want_dw
        say(f"(ii) the profiled b{ZOO_SERVE_BATCH} request: launches {launches_summary(launches)} "
            f"(expected {launches_summary(want)}), depthwise per route {routes} (expected "
            f"{want_dw}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"envelope request launches {launches}, depthwise routes {routes}")
        out["served"] = {"launches": launches_summary(launches), "port_share": share,
                         "device_kernels": len(names)}
        del model
        path = envelope_path(seed, failures)
        parts["ii"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["artifact"] = envelope_artifact(seed, failures)
        parts["iii"] = time.perf_counter() - t0
    out["launches"] = path
    out["seconds"] = parts
    torch.cuda.empty_cache()
    say(json.dumps({"envelope": out}, default=str))
    return path


# phase 18: the Winograd path (ops/winograd.py, gate CONVNETS_TPU_WINOGRAD):
# the two transform kernels of csrc/winograd.cu with the batched cuBLAS
# product between them, on every dense 3x3 stride-1 conv, bare or BN-fused
WINOGRAD_GATE = "CONVNETS_TPU_WINOGRAD"
WINOGRAD_M = (2, 4)
WINOGRAD_KERNELS = ("winograd_input", "winograd_output")
# the JAX package's bars of Winograd against the direct conv
# (tests/test_winograd.py): fp32 max|Δ| / max|ref| per m (the test's atol =
# rtol, taken against the largest output); bf16 its error band: mean |Δ| /
# mean |ref| against the fp32 direct conv below WINOGRAD_BAND × the bf16
# direct conv's (at least 1e-3) and below 2.5%
WINOGRAD_FP32_TOL = {2: 2e-5, 4: 3e-4}
WINOGRAD_BAND, WINOGRAD_BAND_MAX = {2: 2.5, 4: 8.0}, 0.025
VGG_KIND, WINOGRAD_CLI_M = "16", 4  # (iii): VGG-16@32 (the reference's CINIC configuration)
WINOGRAD_KEYS = ("ms_m2", "plain_ms_m2", "bound_ms_m2", "ms_b256", "bound_ms_b256",
                 "ms_b256_m2", "bound_ms_b256_m2", "conv_ms_b256", "conv_ms_b256_m2",
                 "conv_bound_ms_b256", "direct_ms_b256", "cudnn_ms_b256", "stage_bytes_b256",
                 "stage_bytes_b256_m2", "winograd_rn50_launches")


@contextlib.contextmanager
def winograd_gate(value):
    """CONVNETS_TPU_WINOGRAD set to `value` (None: unset) inside."""
    old = os.environ.get(WINOGRAD_GATE)
    if value is None:
        os.environ.pop(WINOGRAD_GATE, None)
    else:
        os.environ[WINOGRAD_GATE] = str(value)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(WINOGRAD_GATE, None)
        else:
            os.environ[WINOGRAD_GATE] = old


def winograd_sites(model):
    """{(H, W, Cin, Cout, pad): uses} of the model's dense 3x3 stride-1
    undilated convs, fused or bare (model_layers), and the total count."""
    sites = {}
    for kind, h, w, cin, cout, k, s, p, _, g, d in model_layers(model, with_dilation=True):
        if kind in ("conv", "plainconv") and (k, s, g, d) == (3, 1, 1, 1):
            sites[(h, w, cin, cout, p)] = sites.get((h, w, cin, cout, p), 0) + 1
    return sites, sum(sites.values())


def winograd_launches(model):
    """(per eval forward, per train step) launches of the model with the
    gate on: model_launches, each Winograd site's conv2d_fused (forward,
    and conv2d_train's forward in a step) or conv2d_stats (a fused site's
    step) traded for one winograd_input and one winograd_output; a fused
    site keeps its reduction and BN passes."""
    fwd, step = (dict(d) for d in model_launches(model))
    for kind, _, _, _, _, k, s, _, _, g, d in model_layers(model, with_dilation=True):
        if kind not in ("conv", "plainconv") or (k, s, g, d) != (3, 1, 1, 1):
            continue
        fwd["conv2d_fused"] -= 1
        step["conv2d_stats" if kind == "conv" else "conv2d_fused"] -= 1
        for launches in (fwd, step):
            for name in WINOGRAD_KERNELS:
                launches[name] += 1
    return fwd, step


def transform_work(m, tiles, c, o, itemsize):
    """(input FLOPs, input bytes, output FLOPs, output bytes) of the two
    transforms: Bᵀ d B as the kernel computes it (a rows of Bᵀ's nonzeros
    on each axis) per tile and channel, x read and V written once; Aᵀ M A
    likewise, M (fp32) read and y written once (tiles·m² outputs, an upper
    bound where the last tiles reach past the output)."""
    from convnets_tpu_torch.ops import winograd

    a = m + 2
    nnz_b, nnz_a = int((winograd._BT[m] != 0).sum()), int((winograd._AT[m] != 0).sum())
    in_flops = 2 * 2 * a * nnz_b * tiles * c
    out_flops = 2 * (a * nnz_a + nnz_a * m) * tiles * o
    return (in_flops, itemsize * a * a * tiles * c, out_flops,
            4 * a * a * tiles * o + itemsize * tiles * m * m * o)


def winograd_band(win, direct, oracle):
    """(error, direct error) as tests/test_winograd.py:87-97 takes them:
    mean |Δ| / mean |oracle| of the bf16 Winograd and the bf16 direct conv
    against the fp32 direct conv."""
    scale = float(oracle.abs().mean())
    return (float((win.float() - oracle).abs().mean()) / scale,
            float((direct.float() - oracle).abs().mean()) / scale)


def winograd_kernel_checks(summary, failures):
    """Phase 18 (i): at every dense 3x3 stride-1 shape of RN50@224 and
    VGG-16@32 (Cin 3 included), m = 2 and 4, b8 fp32 and bf16: the input
    kernel against its plain version (V), the output kernel's three
    epilogues against theirs on one M (bias; scale/shift/ReLU; y and the
    sums of its own stored y within STATS_TOL), the whole conv against
    conv2d_fused within JAX's Winograd bars; the bf16 b8 times into the
    kernels line (RN50's 13 sites, m = 4; m = 2 under *_m2); at b256 bf16
    RN50's four shapes timed stage by stage beside conv2d_fused and cuDNN's
    F.conv2d. Returns the b256 records."""
    import torch

    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.ops import kernels, winograd
    from convnets_tpu_torch.ops.kernels import winograd as wk
    from convnets_tpu_torch.settings import Settings

    rn50 = build_model("resnet", model_setting("resnet", 0, True), device=DEVICE)
    vgg = build_model("vggnet", Settings(kind=VGG_KIND, input_size=(3, 32, 32),
                                      num_classes=ZOO_CLASSES), device=DEVICE)
    (rn_sites, n_rn), (vgg_sites, n_vgg) = winograd_sites(rn50), winograd_sites(vgg)
    del rn50, vgg
    if (n_rn, n_vgg) != (13, 13):
        failures.append(f"winograd sites: RN50 {n_rn}, VGG-16 {n_vgg} (13 each)")
    rows = {name: entry(summary, name) for name in WINOGRAD_KERNELS}
    for row in rows.values():
        row.update({k: 0.0 for k in WINOGRAD_KEYS[:-1] if not k.startswith("stage")})
    g = torch.Generator(device=DEVICE).manual_seed(18)
    n, records, checked = KERNEL_BATCH, [], 0
    say(f"(i) Winograd at N={n}: H W Cin Cout p m dtype | V err, out err (bias / affine / "
        f"stats y, Σ, Σ²), vs conv2d_fused | kernel ms in / out, plain ms in / out")
    for (h, w, cin, cout, p), uses, model in ([(*kv, "rn50") for kv in rn_sites.items()]
                                              + [(*kv, "vgg") for kv in vgg_sites.items()]):
        x32 = torch.randn(n, h, w, cin, device=DEVICE, generator=g)
        w32 = torch.randn(3, 3, cin, cout, device=DEVICE, generator=g) * np.sqrt(2 / (9 * cin))
        b32 = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        scale = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        shift = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        oracle = kernels.conv2d_fused(x32, w32, padding=p)
        direct_bf16 = kernels.conv2d_fused(x32.bfloat16(), w32.bfloat16(), padding=p)
        for m in WINOGRAD_M:
            for dtype in (torch.float32, torch.bfloat16):
                dname = dname_of(dtype)
                atol, rtol = CONV_TOL[dname]
                x, wt, b = x32.to(dtype), w32.to(dtype), b32.to(dtype)
                geo = wk.geometry(x.shape, cout, p, m)
                v = kernels.winograd_input(x, m, p)
                vp = winograd.input_transform_plain(x, m, (p, p))
                e_in = float((v.float() - vp.float()).abs().max())
                a = m + 2
                u = winograd.transform_weight(wt, m, dtype).reshape(a * a, cin, cout)
                mm = winograd.batched_product(vp, u)
                outs = [(kernels.winograd_output(mm, geo, dtype, bias=b),
                         winograd.output_transform_plain(mm, n, geo.oh, geo.ow, m, dtype, bias=b)),
                        (kernels.winograd_output(mm, geo, dtype, scale=scale, shift=shift,
                                                 relu=True),
                         winograd.output_transform_plain(mm, n, geo.oh, geo.ow, m, dtype,
                                                         scale=scale, shift=shift, relu=True))]
                stats = kernels.winograd_output_stats(mm, geo, dtype)
                plain_y = winograd.output_transform_plain(mm, n, geo.oh, geo.ow, m, dtype)
                yf = plain_y.float()
                s_ok, s_err, e1, e2 = stats_check(
                    stats, (plain_y, torch.stack([yf.sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))])),
                    dname, own=True)
                e_out = max(float((o.float() - r.float()).abs().max()) for o, r in outs)
                ok = (e_in <= atol + rtol * float(vp.float().abs().max())
                      and all(within(o, r, atol, rtol) for o, r in outs) and s_ok
                      and all(bool(torch.isfinite(o).all()) for o, _ in outs))
                win = kernels.winograd_conv2d(x, wt, padding=p, m=m)
                if dtype == torch.float32:
                    vs = rel_err(win, oracle)
                    d_ok = vs <= WINOGRAD_FP32_TOL[m]
                    d_txt = f"{vs:.2e} (tol {WINOGRAD_FP32_TOL[m]:g})"
                else:
                    err, err_d = winograd_band(win, direct_bf16, oracle)
                    d_ok = (err < WINOGRAD_BAND[m] * max(err_d, 1e-3)
                            and err < WINOGRAD_BAND_MAX)
                    d_txt = (f"band {err:.2e} vs direct {err_d:.2e} (< {WINOGRAD_BAND[m]:g}× "
                             f"and {WINOGRAD_BAND_MAX:g})")
                ok = ok and d_ok
                checked += 1
                times = ""
                if dtype == torch.bfloat16:
                    k_in = time_ms(lambda: kernels.winograd_input(x, m, p), REPS)
                    p_in = time_ms(lambda: winograd.input_transform_plain(x, m, (p, p)), REPS)
                    k_out = time_ms(lambda: kernels.winograd_output(mm, geo, dtype), REPS)
                    p_out = time_ms(lambda: winograd.output_transform_plain(
                        mm, n, geo.oh, geo.ow, m, dtype), REPS)
                    times = f" | {k_in:.4f} / {k_out:.4f}, {p_in:.4f} / {p_out:.4f}"
                    if model == "rn50":
                        fi, bi, fo, bo = transform_work(m, geo.tiles, cin, cout, 2)
                        for name, k_ms, p_ms, flops, nbytes in (
                                ("winograd_input", k_in, p_in, fi, 2 * x.numel() + bi),
                                ("winograd_output", k_out, p_out, fo, bo)):
                            row = rows[name]
                            if m == 4:
                                add_times(row, uses, k_ms, p_ms, flops, nbytes, None, PEAK_OTHER)
                            else:
                                row["ms_m2"] += uses * k_ms
                                row["plain_ms_m2"] += uses * p_ms
                                row["bound_ms_m2"] += uses * max(1e3 * flops / PEAK_OTHER,
                                                                 1e3 * nbytes / HBM_BPS)
                rows["winograd_input"]["err"] = max(rows["winograd_input"]["err"], e_in)
                rows["winograd_output"]["err"] = max(rows["winograd_output"]["err"], e_out,
                                                     s_err)
                say(f"  {h} {w} {cin} {cout} {p} F({m},3) {dname} | {e_in:.2e}, {e_out:.2e} "
                    f"(Σ {e1:.1e}, Σ² {e2:.1e}), {d_txt} {'ok' if ok else 'FAIL'}{times}")
                if not ok:
                    failures.append(f"winograd {h}x{w} {cin}->{cout} m={m} {dname}: V {e_in:.2e}, "
                                    f"out {e_out:.2e}, stats {s_ok}, vs direct {d_txt}")
    for (h, w, cin, cout, p), uses in rn_sites.items():
        records.append(winograd_b256(h, w, cin, cout, p, uses, rows, g, failures))
    say(f"(i) {checked} checked calls; RN50's 13 sites at N=8 bf16, F(4,3): input kernel "
        f"{rows['winograd_input']['ms']:.4f} ms (bound {rows['winograd_input']['bound_ms']:.4f}), "
        f"output kernel {rows['winograd_output']['ms']:.4f} ms (bound "
        f"{rows['winograd_output']['bound_ms']:.4f}); F(2,3) "
        f"{rows['winograd_input']['ms_m2']:.4f} / {rows['winograd_output']['ms_m2']:.4f} ms")
    return records


def winograd_b256(h, w, cin, cout, p, uses, rows, g, failures):
    """One RN50 shape at b256 bf16, m = 2 and 4: first the kernels at the
    main path's shape against their plain versions on the same inputs (V
    within CONV_TOL of input_transform_plain; on one M, each of the three
    epilogues within CONV_TOL of output_transform_plain, the statistics
    epilogue's sums within STATS_TOL of those of its own stored y); then
    each stage's device ms (input kernel, batched product, output kernel),
    the whole conv (winograd_conv2d: weight transform included),
    conv2d_fused and cuDNN's F.conv2d, the conv's bound max((x + w + y
    bytes) / HBM, a²·P·C·O·2 / 989 TFLOP/s) and each stage's bytes; added
    `uses` times to the rows."""
    import torch

    from convnets_tpu_torch.ops import kernels, winograd
    from convnets_tpu_torch.ops.kernels import winograd as wk

    n = B256
    x = torch.randn(n, h, w, cin, device=DEVICE, generator=g).bfloat16()
    wt = (torch.randn(3, 3, cin, cout, device=DEVICE, generator=g) / np.sqrt(9 * cin)).bfloat16()
    direct_ms = time_ms(lambda: kernels.conv2d_fused(x, wt, padding=p), REPS)
    lib = conv_lib(1, p)
    cudnn_ms = time_ms(lambda: lib(x, wt), REPS)
    bias = (0.1 * torch.randn(cout, device=DEVICE, generator=g)).bfloat16()
    scale = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
    shift = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
    atol, rtol = CONV_TOL["bfloat16"]
    rec = {"shape": (n, h, w, cin, cout, p), "uses": uses, "direct_ms": direct_ms,
           "cudnn_ms": cudnn_ms}
    _, direct_bytes = conv_work(n, h, w, cin, cout, 3, 1, p)
    for m in WINOGRAD_M:
        a = m + 2
        geo = wk.geometry(x.shape, cout, p, m)
        u = winograd.transform_weight(wt, m, torch.bfloat16).reshape(a * a, cin, cout)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        v = kernels.winograd_input(x, m, p)
        mm = winograd.batched_product(v, u)
        kernels.winograd_output(mm, geo, torch.bfloat16)
        sync()
        temps = torch.cuda.max_memory_allocated() - base
        # the kernels against their plain versions at this shape, before timing
        vp = winograd.input_transform_plain(x, m, (p, p))
        e_in = float((v.float() - vp.float()).abs().max())
        in_ok = e_in <= atol + rtol * float(vp.float().abs().max())
        del vp
        errs = {}
        for epi, kw in (("bias", dict(bias=bias)),
                        ("affine", dict(scale=scale, shift=shift, relu=True))):
            got = kernels.winograd_output(mm, geo, torch.bfloat16, **kw)
            ref = winograd.output_transform_plain(mm, n, geo.oh, geo.ow, m, torch.bfloat16, **kw)
            errs[epi] = (float((got.float() - ref.float()).abs().max()),
                         within(got, ref, atol, rtol) and bool(torch.isfinite(got).all()))
            del got, ref
        plain_y = winograd.output_transform_plain(mm, n, geo.oh, geo.ow, m, torch.bfloat16)
        s_ok, s_err, e1, e2 = stats_check(kernels.winograd_output_stats(mm, geo, torch.bfloat16),
                                          (plain_y, (None, None)), "bfloat16", own=True)
        del plain_y
        e_out = max([e for e, _ in errs.values()] + [s_err])
        ok = in_ok and s_ok and all(o for _, o in errs.values())
        rows["winograd_input"]["err"] = max(rows["winograd_input"]["err"], e_in)
        rows["winograd_output"]["err"] = max(rows["winograd_output"]["err"], e_out)
        say(f"  b{n} bf16 {h}x{w} {cin}->{cout} F({m},3) vs plain: V {e_in:.2e}, out bias "
            f"{errs['bias'][0]:.2e} / affine {errs['affine'][0]:.2e} / stats y {s_err:.2e} "
            f"(Σ {e1:.1e}, Σ² {e2:.1e}; tol {atol:g}+{rtol:g}|ref|, sums "
            f"{STATS_TOL['bfloat16']:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"winograd b{n} {h}x{w} {cin}->{cout} m={m} bf16 vs plain: V "
                            f"{e_in:.2e}, out {errs}, stats {s_ok} ({s_err:.2e}, {e1:.1e}, "
                            f"{e2:.1e})")
        t_in = time_ms(lambda: kernels.winograd_input(x, m, p), REPS)
        t_mm = time_ms(lambda: winograd.batched_product(v, u), REPS)
        t_out = time_ms(lambda: kernels.winograd_output(mm, geo, torch.bfloat16), REPS)
        t_conv = time_ms(lambda: kernels.winograd_conv2d(x, wt, padding=p, m=m), REPS)
        del v, mm
        flops = 2 * a * a * geo.tiles * cin * cout
        bound = max(1e3 * direct_bytes / HBM_BPS, 1e3 * flops / PEAK_BF16)
        fi, bi, fo, bo = transform_work(m, geo.tiles, cin, cout, 2)
        stage_bytes = {"input": 2 * x.numel() + bi,
                       "product": bi + 2 * u.numel() + 4 * a * a * geo.tiles * cout, "output": bo}
        b_in = max(1e3 * fi / PEAK_OTHER, 1e3 * stage_bytes["input"] / HBM_BPS)
        b_out = max(1e3 * fo / PEAK_OTHER, 1e3 * bo / HBM_BPS)
        suffix = "" if m == 4 else "_m2"
        for name, t, b in (("winograd_input", t_in, b_in), ("winograd_output", t_out, b_out)):
            rows[name]["ms_b256" + suffix] += uses * t
            rows[name]["bound_ms_b256" + suffix] += uses * b
            rows[name]["conv_ms_b256" + suffix] += uses * t_conv
            rows[name].setdefault("stage_bytes_b256" + suffix, {})[f"{h}x{w}x{cin}"] = stage_bytes
        if m == 4:
            for name in WINOGRAD_KERNELS:
                rows[name]["conv_bound_ms_b256"] += uses * bound
                rows[name]["direct_ms_b256"] += uses * direct_ms
                rows[name]["cudnn_ms_b256"] += uses * cudnn_ms
        rec[f"m{m}"] = {"input_ms": t_in, "product_ms": t_mm, "output_ms": t_out,
                        "conv_ms": t_conv, "bound_ms": bound, "stage_bytes": stage_bytes,
                        "temporaries_bytes": temps, "err_input": e_in, "err_output": e_out,
                        "sums_err": [e1, e2]}
        say(f"  b{n} bf16 {h}x{w} {cin}->{cout} F({m},3): input {t_in:.4f} + product "
            f"{t_mm:.4f} + output {t_out:.4f} ms, whole conv {t_conv:.4f} ms (bound "
            f"{bound:.4f}, {t_conv / bound:.1f}×); conv2d_fused {direct_ms:.4f}, cuDNN "
            f"{cudnn_ms:.4f}; stage bytes {stage_bytes}; V and M peak {temps / 2 ** 30:.3f} GiB")
    return rec


def winograd_rn50(seed, failures):
    """Phase 18 (ii): RN50@224 bf16 b256 with bench.py's settings, the gate
    off, 2, 4 in turns, WARMUP + TIMED steps a run: launches per step exact
    (13 Winograd sites: 13 + 13 transform launches, 40 conv2d_stats, 53
    reductions; off: TRAIN_LAUNCHES), img/s and peak memory; then three
    steps a gate under the profiler (CUDA activity), the device ms per step; one served b256 request
    per gate (launches per forward exact), a gated one's argmax = the plain
    path's (plain_kernels) on >= ARGMAX_MIN. Returns (the record, the gated
    runs' launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.serve import ServingModel

    batch, out, path = TRAIN_BATCH["resnet"], {}, {}
    model = make_model("resnet", seed, True)
    fwd_on, step_on = winograd_launches(model)
    want = {None: (launches_of(SERVE_LAUNCHES["resnet"]), launches_of(TRAIN_LAUNCHES["resnet"])),
            2: (fwd_on, step_on), 4: (fwd_on, step_on)}
    state, step = train_state(model)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randint(0, 256, (batch, IMAGE, IMAGE, 3), dtype=torch.uint8, device=DEVICE,
                      generator=gen)
    y = torch.randint(0, 1000, (batch,), device=DEVICE, generator=gen)
    runs = {}
    for m in (None, 2, 4):
        with winograd_gate(m):
            sync()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            seconds, loss = timed_steps(step, state, x, y, gen)
            sync()
            got = {k: v / sum((WARMUP, TIMED)) for k, v in kernels.LAUNCHES.items()}
            if m is not None:
                for k, v in kernels.LAUNCHES.items():
                    path[k] = path.get(k, 0) + v
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    step(state, x, y, generator=gen)
                sync()
        device, ours, _ = device_split(prof, OUR_KERNELS)
        runs[m] = {"img_s": batch / seconds, "peak_gib": peak, "loss": float(loss),
                   "device_ms_per_step": device / 3e3, "kernels_ms_per_step": ours / 3e3}
        ok = got == want[m][1] and np.isfinite(float(loss))
        say(f"(ii) RN50@224 bf16 b{batch} train, gate {m or 'off'} ({WARMUP} + {TIMED} steps): "
            f"img/s {runs[m]['img_s']:.1f}, peak {peak:.2f} GiB; device ms per step (profiler, "
            f"CUDA activity, 3 steps) {runs[m]['device_ms_per_step']:.3f}: the port's kernels "
            f"{runs[m]['kernels_ms_per_step']:.3f}; launches per step {launches_summary(got)} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"winograd RN50 b{batch} gate {m}: launches per step "
                            f"{launches_summary(got)} (expected {launches_summary(want[m][1])}), "
                            f"loss {float(loss)}")
    out["train"] = {str(m): r for m, r in runs.items()}
    model.eval()
    server = ServingModel(model, input_dtype="uint8", stats=IMAGENET_STATS)
    req = np.random.default_rng(seed + 18).integers(0, 256, (batch, IMAGE, IMAGE, 3),
                                                    dtype=np.uint8)
    served, vs_plain = {}, {}
    for m in (None, 2, 4):
        with winograd_gate(m):
            server(req)
            sync()
            kernels.reset_launches()
            logits = server(req)
            sync()
            got = dict(kernels.LAUNCHES)
            if m is not None:
                for k, v in got.items():
                    path[k] = path.get(k, 0) + v
                with plain_kernels():
                    ref = server(req).float()
                sync()
        served[m] = logits.float()
        ok = got == want[m][0] and bool(torch.isfinite(logits).all())
        txt = ""
        if m is not None:
            agree = float((served[m].argmax(-1) == ref.argmax(-1)).float().mean())
            vs_plain[m] = {"argmax_agreement": agree,
                           "max_abs_diff": float((served[m] - ref).abs().max()),
                           "max_abs_logit": float(ref.abs().max())}
            ok = ok and agree >= ARGMAX_MIN
            txt = (f"; logits vs the plain path: argmax agreement {agree:.4f} (min {ARGMAX_MIN}), "
                   f"max |Δ| {vs_plain[m]['max_abs_diff']:.4e} (max |logit| "
                   f"{vs_plain[m]['max_abs_logit']:.4e})")
        say(f"(ii) served b{batch} uint8 request, gate {m or 'off'}: launches "
            f"{launches_summary(got)}{txt} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"winograd RN50 request gate {m}: {launches_summary(got)}, vs plain "
                            f"{vs_plain.get(m)}")
    agree = {m: float((served[m].argmax(-1) == served[None].argmax(-1)).float().mean())
             for m in (2, 4)}
    say(f"    argmax of the gated requests = the ungated's on {agree} (recorded, no bar: "
        f"random weights)")
    out["served_vs_plain"] = vs_plain
    out["served_argmax_agreement"] = agree
    del server, model, state
    return out, path


def winograd_rn50_checks(seed, failures):
    """Phase 18 (ii)'s untimed checks at each gate: the fp32 b8 SGD step
    against the plain path (its Winograd wrappers by winograd_conv2d_plain)
    beside the perturbed control, and ten bf16 Adam steps of RN50 with a
    falling loss."""
    out = {}
    for m in WINOGRAD_M:
        with winograd_gate(m):
            out[f"step_m{m}"] = step_check("resnet", seed, failures)
            out[f"learn_m{m}"] = winograd_learn(seed, failures, m)
    return out


def winograd_learn(seed, failures, m):
    """Ten bf16 Adam steps of RN50@224 at LEARN_BATCH on one batch with the
    gate at m: the loss falls."""
    import torch

    rng = np.random.default_rng(seed + 3)
    x = torch.from_numpy(rng.integers(0, 256, (LEARN_BATCH, IMAGE, IMAGE, 3),
                                      dtype=np.uint8)).to(DEVICE)
    y = torch.from_numpy(rng.integers(0, 1000, LEARN_BATCH)).to(DEVICE)
    model = make_model("resnet", seed, True, dropout_rate=0.0, learning_rate=LEARN_LR["resnet"])
    state, step = train_state(model, norm=True, stats=IMAGENET_STATS)
    losses = [float(step(state, x, y)[0]) for _ in range(LEARN_STEPS)]
    falls = losses[-1] < losses[0] and all(np.isfinite(losses))
    say(f"(ii) gate {m}: {LEARN_STEPS} bf16 Adam steps of RN50 (b{LEARN_BATCH}), loss "
        f"{[round(v, 3) for v in losses]} falls: {'ok' if falls else 'FAIL'}")
    if not falls:
        failures.append(f"winograd gate {m}: bf16 loss did not fall {losses}")
    return losses


def winograd_vgg_cli(seed, card, failures):
    """Phase 18 (iii): VGG-16@32 (10 classes) with the gate at
    WINOGRAD_CLI_M through the CLI on phase 12's PNG tree: a
    CLI_FAMILY_EPOCHS fit at CLI_FAMILY_BATCH (replayed graphs), every call's
    launches exact (winograd_launches), the loss falls; export --bake-norm,
    load --testing; the artifact loaded in process, one profiled b256
    request with no library convolution kernel; and served by a fresh
    process with the gate unset (CLI_CHILD) on the test split: its argmax
    = Trainer.test's on >= ARGMAX_MIN. The fresh process is started last
    and left running (most of its time is importing torch), so other work
    goes on beside it; returns finish(), which waits for it, checks it,
    removes the files and returns (the record, the path's launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from convnets_tpu_torch.__main__ import main as cli_main
    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.serve import load_artifact

    out, seconds = {}, {}
    n_test = CLI_SPLITS[2][1]
    rec = new_record()
    tmp = tempfile.mkdtemp()
    with contextlib.ExitStack() as undo, winograd_gate(WINOGRAD_CLI_M):
        undo.callback(shutil.rmtree, tmp, ignore_errors=True)  # unless the child starts
        t0 = time.perf_counter()
        root = cli_tree(seed)
        seconds["tree"] = time.perf_counter() - t0
        args = ["--arch", "vggnet", "--kind", VGG_KIND, "--input-size", "3,32,32", "--num-classes",
                str(ZOO_CLASSES), "--data-root", root, "--seed", str(seed), "--batch-size",
                str(CLI_FAMILY_BATCH), "--output-dir", os.path.join(tmp, "vgg")]
        art = os.path.join(tmp, "vgg16.bin")
        sync()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with recorded_trainers(rec):
            rc = cli_main(["fit", *args, "--epochs", str(CLI_FAMILY_EPOCHS)])
            sync()
            trainer = rec["trainers"][-1]
            loss = list(trainer.epoch_results["train_loss"])
            fwd, step = winograd_launches(trainer.model)
            seconds["fit"] = time.perf_counter() - t0
            rc_e = cli_main(["export", *args, "--bake-norm", "--out", art])
            rec["capture"] = True
            rc_t = cli_main(["load", *args, "--testing"])
            rec["capture"] = False
            sync()
        launches = dict(kernels.LAUNCHES)
        seconds["export_test"] = time.perf_counter() - t0 - seconds["fit"]
        ok_fit = (rc == 0 and rc_e == 0 and rc_t == 0 and len(loss) == CLI_FAMILY_EPOCHS
                  and all(np.isfinite(loss)) and loss[-1] < loss[0])
        say(f"(iii) CLI fit VGG-16@32 gate {WINOGRAD_CLI_M}, b{CLI_FAMILY_BATCH}, "
            f"{CLI_FAMILY_EPOCHS} epochs: exit {rc}, train loss {loss}, export {rc_e}, load "
            f"--testing {rc_t} {'ok' if ok_fit else 'FAIL'}")
        if not ok_fit:
            failures.append(f"winograd VGG CLI: exits {rc}/{rc_e}/{rc_t}, loss {loss}")
        ok_calls = check_calls("VGG-16@32 gated CLI", rec, step, fwd, failures)
        batches = -(-n_test // CLI_FAMILY_BATCH)
        timed = rec["eval_io"][-batches:]  # test()'s timed loop
        xs = torch.cat([xb[wb > 0] for xb, _, wb in timed]).numpy()
        tested = torch.cat([pb[wb > 0] for _, pb, wb in timed]).numpy()
        # the artifact in process: one profiled b256 request
        served = load_artifact(art)
        req = xs[:ZOO_SERVE_BATCH].astype(np.float32) / 255.0
        served(req)
        sync()
        kernels.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            logits = served(req)
            sync()
        req_launches = dict(kernels.LAUNCHES)
        for k, v in req_launches.items():
            launches[k] = launches.get(k, 0) + v
        bad = library_convs(prof)
        ok_req = (not bad and req_launches == fwd and bool(torch.isfinite(logits).all()))
        say(f"(iii) the artifact's b{ZOO_SERVE_BATCH} request in process under the profiler: "
            f"launches {launches_summary(req_launches)} (expected {launches_summary(fwd)}), "
            f"library convolution kernels {bad} {'ok' if ok_req else 'FAIL'}")
        if not ok_req:
            failures.append(f"winograd VGG artifact request: launches {req_launches}, "
                            f"library convs {bad}")
        del served
        xfile = os.path.join(tmp, "vgg_test_x.npy")
        np.save(xfile, xs)
        env = {k: v for k, v in os.environ.items() if k != WINOGRAD_GATE}
        t_child = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-c", CLI_CHILD, HERE, art, xfile],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        undo.pop_all()
    done = []

    def finish():
        if done:
            return done[0]
        try:
            child = finished(proc, 600)
        finally:
            if proc.poll() is None:  # none outlives the phase
                proc.kill()
                proc.wait()
            shutil.rmtree(tmp, ignore_errors=True)
        seconds["fresh_process"] = time.perf_counter() - t_child
        res = json.loads(child.stdout.strip().splitlines()[-1]) if child.returncode == 0 else {}
        agree = (float((np.asarray(res.get("argmax", [])) == tested).mean())
                 if len(res.get("argmax", [])) == len(tested) else 0.0)
        requests = -(-len(tested) // 256)
        want_child = launches_summary({k: v * requests for k, v in fwd.items()})
        ok_art = (child.returncode == 0 and agree >= ARGMAX_MIN and len(tested) == n_test
                  and res.get("launches") == want_child)
        say(f"(iii) the artifact served by a fresh process (gate unset) on the {len(tested)} "
            f"test images: argmax = Trainer.test's on {agree:.4f} (min {ARGMAX_MIN}), launches "
            f"{res.get('launches')} (expected {want_child}) {'ok' if ok_art else 'FAIL'}")
        if not ok_art:
            failures.append(f"winograd VGG artifact: rc {child.returncode}, agreement {agree}, "
                            f"launches {res.get('launches')}, {child.stderr[-2000:]}")
        out.update({"train_loss": loss, "launches_ok": ok_calls,
                    "launches_per_train_step": launches_summary(step),
                    "launches_per_eval_call": launches_summary(fwd), "argmax_agreement": agree,
                    "epoch_img_s": [CLI_SPLITS[0][1] / t for t in rec["epoch_s"]],
                    "library_convs": bad, "seconds": seconds, "card": card})
        done.append((out, launches))
        return done[0]

    return finish


def phase_winograd(seed, card, summary, failures):
    """Phase 18: (i) winograd_kernel_checks; (ii) winograd_rn50 and
    winograd_rn50_checks; (iii) winograd_vgg_cli, started first so that
    (i) and (ii)'s checks run beside its fresh process. Prints the winograd
    JSON line; returns the launches of (ii)'s gated runs and of (iii)'s
    path."""
    import torch

    out, parts = {"card": card}, {}
    t0 = time.perf_counter()
    finish_cli = winograd_vgg_cli(seed, card, failures)
    parts["iii"] = time.perf_counter() - t0
    try:
        # beside (iii)'s fresh process: the kernel checks and (ii)'s
        # untimed steps; the timed turns after it has finished
        t0 = time.perf_counter()
        out["b256"] = winograd_kernel_checks(summary, failures)
        parts["i"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        checks = winograd_rn50_checks(seed, failures)
        parts["ii_checks"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["vgg_cli"], cli_path = finish_cli()
        parts["iii_fresh_process_wait"] = time.perf_counter() - t0
    finally:
        finish_cli()
    t0 = time.perf_counter()
    out["rn50"], rn50_path = winograd_rn50(seed, failures)
    out["rn50"].update(checks)
    parts["ii"] = time.perf_counter() - t0
    out["seconds"] = parts
    for name in WINOGRAD_KERNELS:
        summary[name]["winograd_rn50_launches"] = rn50_path[name]
    torch.cuda.empty_cache()
    say(json.dumps({"winograd": out}, default=str))
    return rn50_path, cli_path


# phase 19: the native image codec (convnets_tpu_torch/native) on the card's host
CODEC_GATE = "CONVNETS_TPU_NATIVE_DECODE"
CODEC_JPEG = (256, 375, 500)  # images, height, width: ImageNet-shaped JPEGs (500x375)
CODEC_JPEG_QUALITY = 90
CODEC_RESIZE = (224, 224)
# the CPU tests' bars against PIL (tests/test_torch_native_codec.py): PNG
# decode exact; JPEG mean |Δ| per image (IDCT rounding may differ between
# libjpeg builds)
CODEC_JPEG_MEAN = 1.0
# a build that fails for lack of one of these is the host's installation:
# reported, and the data path then decodes with PIL
CODEC_MISSING = ("png.h", "jpeglib.h", "-lpng", "-ljpeg")
# the gate of each timed turn: PIL, native, native, PIL; where the codec did
# not build, both gates decode with PIL and one turn of each runs
CODEC_TURNS = ("0", "1", "1", "0")
CODEC_TURNS_UNBUILT = ("0", "1")
CODEC_WORKERS = 16  # the CLI's DataLoader decode threads (Settings.DEF_NUM_WORKERS)
CODEC_LOADER_BATCH = 16  # (ii): the DataLoader's batch, so that all its threads have work


@contextlib.contextmanager
def codec_gate(value):
    """CONVNETS_TPU_NATIVE_DECODE set to `value` inside, restored after."""
    old = os.environ.get(CODEC_GATE)
    os.environ[CODEC_GATE] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(CODEC_GATE, None)
        else:
            os.environ[CODEC_GATE] = old


def write_jpeg_tree(root, seed):
    """CODEC_JPEG's images of synthetic_dataset(learnable=True) from seed +
    30 as JPEGs of quality CODEC_JPEG_QUALITY under root/class<label>/."""
    from PIL import Image

    from convnets_tpu_torch.data import synthetic_dataset

    n, h, w = CODEC_JPEG
    ds = synthetic_dataset(n, (h, w, 3), ZOO_CLASSES, seed=seed + 30, learnable=True)
    images, labels = (ds.images * 255).round().astype(np.uint8), ds.labels
    for c in range(ZOO_CLASSES):
        os.makedirs(os.path.join(root, f"class{c}"))
    for j, (img, label) in enumerate(zip(images, labels)):
        Image.fromarray(img).save(os.path.join(root, f"class{label}", f"{j:05d}.jpg"),
                                  quality=CODEC_JPEG_QUALITY)


def codec_toolchain():
    """Which of CODEC_MISSING this host's g++ finds: each header by
    preprocessing an #include of it, each library by linking against it."""
    found = {}
    with tempfile.TemporaryDirectory() as tmp:
        for item in CODEC_MISSING:
            if item.endswith(".h"):
                cmd = ["g++", "-E", "-x", "c++", "-", "-o", os.devnull]
                src = f"#include <{item}>\n"
            else:
                cmd = ["g++", "-shared", "-x", "c++", "-", item, "-o",
                       os.path.join(tmp, "probe.so")]
                src = "int probe() { return 0; }\n"
            try:
                found[item] = subprocess.run(cmd, input=src, capture_output=True, text=True,
                                             timeout=60).returncode == 0
            except (OSError, subprocess.SubprocessError):
                found[item] = False
    return found


def codec_status(failures):
    """(i) whether the codec built here, its build error, and what the
    toolchain finds. A build that fails for a missing header or library of
    CODEC_MISSING is reported (the data path then decodes with PIL); any
    other failure fails the phase."""
    from convnets_tpu_torch import native

    t0 = time.perf_counter()
    with codec_gate("1"):
        have = native.available()
    seconds = time.perf_counter() - t0
    error = native.build_error()
    found = codec_toolchain()
    named = [m for m in CODEC_MISSING if error and m in error and not found[m]]
    ok = have or bool(named)
    tail = (error or "").strip().splitlines()[-3:]
    say(f"(i) codec: {'built' if have else 'NOT built'} in {seconds:.2f} s "
        f"({native.LIB_PATH}); the toolchain finds {found}"
        + ("" if have else f"; g++'s error names {named}: {tail}") + (" ok" if ok else " FAIL"))
    if not ok:
        failures.append(f"codec build failed, not for a missing codec header or library: "
                        f"{error}")
    return have, {"built": have, "build_seconds": seconds, "toolchain": found,
                  "build_error_tail": tail, "missing_named": named}


def load_all(ds):
    """ds.load_raw over every index, in os.cpu_count() threads (both decode
    routes release the GIL); the images in index order."""
    from concurrent.futures import ThreadPoolExecutor

    chunks = np.array_split(np.arange(len(ds)), os.cpu_count() or 1)
    with ThreadPoolExecutor(len(chunks)) as ex:
        return np.concatenate(list(ex.map(lambda idx: ds.load_raw(idx)[0], chunks)))


def codec_parity(png_roots, jpeg_root, have, failures):
    """(i) every image of each tree through ImageFolderDataset.load_raw
    with the gate on and off: the route counters exact (native on every
    image where the codec built, else PIL), the cache tag, and the two
    routes' images within the CPU tests' bars (PNG bit for bit; JPEG
    mean |Δ| ≤ CODEC_JPEG_MEAN per image, at native size and at 224²)."""
    from convnets_tpu_torch import native
    from convnets_tpu_torch.data import ImageFolderDataset

    cases = ([(f"png 32² {os.path.basename(r)}", r, None) for r in png_roots]
             + [("jpeg 500x375", jpeg_root, None), ("jpeg -> 224²", jpeg_root, CODEC_RESIZE)])
    out = {}
    for label, root, size in cases:
        images, counts, tags = {}, {}, {}
        for gate in ("1", "0"):
            with codec_gate(gate):
                ds = ImageFolderDataset(root, image_size=size, cache=False)
                native.reset_decodes()
                images[gate] = load_all(ds)
                counts[gate], tags[gate] = dict(native.DECODES), ds._decoder_id()
        n = len(ds)
        want = {"1": {"native": n, "pil": 0} if have else {"native": 0, "pil": n},
                "0": {"native": 0, "pil": n}}
        want_tags = ({"1": "any", "0": "any"} if size is None
                     else {"1": "native" if have else "pil", "0": "pil"})
        d = np.abs(images["1"].astype(np.int16) - images["0"].astype(np.int16))
        per_image = d.reshape(n, -1).mean(1)
        if label.startswith("png"):
            close = not d.any()
        else:
            close = bool(per_image.max() <= CODEC_JPEG_MEAN)
        ok = close and counts == want and tags == want_tags
        say(f"    {label}: {n} images, native route against PIL max |Δ| {int(d.max())}, "
            f"largest per-image mean |Δ| {per_image.max():.4f}; decodes gate=1 {counts['1']}, "
            f"gate=0 {counts['0']}; cache tags {tags} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"codec parity {label}: max {d.max()}, mean {per_image.max()}, "
                            f"decodes {counts} (want {want}), tags {tags} (want {want_tags})")
        out[label] = {"images": n, "max_abs": int(d.max()), "max_image_mean_abs":
                      float(per_image.max()), "decodes": counts, "tags": tags}
    return out


def codec_rates(png_root, jpeg_root, turns):
    """(ii) decode img/s on the host, the gate in `turns`: one thread
    decoding every image of the tree in order, then the port's DataLoader
    over it with the CLI's CODEC_WORKERS threads; with the route counters
    of each turn."""
    from convnets_tpu_torch import native
    from convnets_tpu_torch.data import DataLoader, ImageFolderDataset

    out = {}
    for label, root, size in (("png 32²", png_root, None), ("jpeg 500x375", jpeg_root, None),
                              ("jpeg -> 224²", jpeg_root, CODEC_RESIZE)):
        runs = []
        for gate in turns:
            with codec_gate(gate):
                ds = ImageFolderDataset(root, image_size=size, cache=False)
                native.reset_decodes()
                t0 = time.perf_counter()
                for i in range(len(ds)):
                    ds._decode(i)
                one = len(ds) / (time.perf_counter() - t0)
                loader = DataLoader(ds, CODEC_LOADER_BATCH, num_workers=CODEC_WORKERS)
                t0 = time.perf_counter()
                for _ in loader:
                    pass
                many = len(ds) / (time.perf_counter() - t0)
                runs.append({"gate": gate, "one_thread_img_s": one, "loader_img_s": many,
                             "decodes": dict(native.DECODES)})
        out[label] = runs
        say(f"(ii) {label}, {len(ds)} images: img/s one thread / DataLoader "
            f"({CODEC_WORKERS} threads, batch {CODEC_LOADER_BATCH}) per turn "
            + "; ".join(f"gate={t['gate']} {t['one_thread_img_s']:.1f} / "
                        f"{t['loader_img_s']:.1f} ({t['decodes']})" for t in runs))
    return out


def profile_last_epoch(trainer, out):
    """Run the fit's last train epoch under torch.profiler (device
    activity); append (device µs, host s) of it to `out`."""
    from torch.profiler import ProfilerActivity, profile

    run = trainer._run_train_epoch

    def profiled(loader, epoch_index):
        if epoch_index != trainer.setting.epochs - 1:
            return run(loader, epoch_index)
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            result = run(loader, epoch_index)
            sync()
            host = time.perf_counter() - t0
        out.append((device_split(prof, OUR_KERNELS)[0], host))
        return result

    trainer._run_train_epoch = profiled


def codec_fit(seed, have, turns, failures):
    """(iii) RN26@32 bf16 b256 (phase 10's settings) fitted 2 epochs from a
    host DataLoader (CODEC_WORKERS threads) over ImageFolderDataset(...,
    cache=False) of phase 12's PNG tree, so that every epoch decodes every
    image, the gate in `turns`, each fit from the same weights: every train
    step 29 conv2d_stats + 29 reductions + 1 max_pool2d + 1 pool2d_backward
    + the BN passes, every eval batch 29 conv2d_fused + 1 max_pool2d; the
    decodes' routes; the epoch losses of the fits equal bit for bit; epoch
    img/s and the device-idle share of the last epoch (profiled). Returns
    (results, the path's launches)."""
    from convnets_tpu_torch import native
    from convnets_tpu_torch.data import DataLoader, ImageFolderDataset
    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.train import Trainer

    root = cli_tree(seed)
    rec, runs, first = new_record(), [], None
    with tempfile.TemporaryDirectory() as out_dir:
        sync()
        kernels.reset_launches()
        for turn, gate in enumerate(turns):
            with codec_gate(gate):
                setting = trainer_setting(seed, os.path.join(out_dir, str(turn)))
                model = build_model("resnet", setting, device=DEVICE)
                if first is None:
                    first = {k: v.clone() for k, v in model.state_dict().items()}
                model.load_state_dict(first)
                trainer = Trainer(model)
                n = conv_count(trainer.model)
                count_calls(trainer, rec)
                epoch_s, profiled = [], []
                profile_last_epoch(trainer, profiled)
                timed_train_epochs(trainer, epoch_s)
                train_ds, valid_ds = (ImageFolderDataset(os.path.join(root, split), cache=False)
                                      for split in ("train", "valid"))
                train = DataLoader(train_ds, TRAINER_BATCH, shuffle=True, seed=seed,
                                   num_workers=CODEC_WORKERS)
                valid = DataLoader(valid_ds, TRAINER_BATCH)
                native.reset_decodes()
                sync()
                t0 = time.perf_counter()
                trainer.fit(train, valid)
                sync()
                host = time.perf_counter() - t0
                trainer.close()
                (device, epoch_host), = profiled
                r = trainer.epoch_results
                runs.append({"gate": gate, "decodes": dict(native.DECODES),
                             "train_loss": list(r["train_loss"]),
                             "valid_loss": list(r["valid_loss"]),
                             "epoch_img_s": [len(train_ds) / s for s in epoch_s],
                             "fit_s": host, "profiled_epoch_host_ms": 1e3 * epoch_host,
                             "profiled_epoch_device_ms": device / 1e3,
                             "idle_share": 1.0 - device / 1e6 / epoch_host})
        sync()
        totals = dict(kernels.LAUNCHES)
    check_routes("decoded fit", totals, failures)
    per_step = launches_of({"conv2d_stats": 29, "conv2d_stats_reduce": 29, "max_pool2d": 1,
                            "pool2d_backward": 1, **bn_sites(29)})
    per_eval = launches_of({"conv2d_fused": 29, "max_pool2d": 1})
    check_calls("(iii) decoded fits", rec, per_step, per_eval, failures)
    images = TRAINER_EPOCHS * (len(train_ds) + len(valid_ds))
    route = "native" if have else "pil"
    want = {"native": 0, "pil": 0, route: images}
    ok_routes = all(run["decodes"] == (want if run["gate"] == "1" else
                                       {"native": 0, "pil": images}) for run in runs)
    losses = [(run["train_loss"], run["valid_loss"]) for run in runs]
    ok_losses = all(l == losses[0] for l in losses)
    for run in runs:
        say(f"    gate={run['gate']}: decodes {run['decodes']}, train loss {run['train_loss']}, "
            f"valid loss {run['valid_loss']}, epoch img/s "
            f"{[round(v, 1) for v in run['epoch_img_s']]} (the last one profiled), fit "
            f"{run['fit_s']:.2f} s; last epoch device {run['profiled_epoch_device_ms']:.1f} ms of "
            f"{run['profiled_epoch_host_ms']:.1f} ms host, idle share {run['idle_share']:.4f}")
    say(f"(iii) {len(runs)} fits of RN26@32 bf16 b{TRAINER_BATCH} over the decoded PNG tree "
        f"({n} convs): decodes per fit on the {route} route with the gate on {want}: "
        f"{'ok' if ok_routes else 'FAIL'}; epoch losses bit for bit across the decoders: "
        f"{'ok' if ok_losses else 'FAIL'}")
    if n != 29:
        failures.append(f"decoded fit: {n} convs, not RN26's 29")
    if not ok_routes:
        failures.append(f"decoded fit decodes: {[run['decodes'] for run in runs]}")
    if not ok_losses:
        failures.append(f"decoded fit losses differ across the decoders: {losses}")
    return ({"runs": runs, "launches_per_train_step": {k: v for k, v in per_step.items() if v},
             "launches_per_eval_batch": {k: v for k, v in per_eval.items() if v},
             "decodes_per_fit": images, "fit_launches": {k: v for k, v in totals.items() if v}},
            path_launches(totals, rec))


def phase_codec(seed, card, failures):
    """Phase 19: the native image codec on the card's host. (i) whether it
    built, and parity on phase 12's PNG tree and a JPEG tree written here;
    (ii) decode img/s; (iii) RN26@32 fitted over the decoded tree under
    both decoders. Prints the codec JSON line; returns the launches of
    (iii)'s path."""
    parts, out = {}, {"card": card, "nproc": os.cpu_count(),
                      "cpus_usable": len(os.sched_getaffinity(0))}
    say(f"codec host: {out['nproc']} CPUs ({out['cpus_usable']} usable), {card}")
    t0 = time.perf_counter()
    have, out["status"] = codec_status(failures)
    turns = CODEC_TURNS if have else CODEC_TURNS_UNBUILT
    png_roots = [os.path.join(cli_tree(seed), split) for split, _ in CLI_SPLITS]
    parts["i_status_tree"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        jpeg_root = os.path.join(tmp, "jpeg")
        write_jpeg_tree(jpeg_root, seed)
        parts["jpeg_tree"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["parity"] = codec_parity(png_roots, jpeg_root, have, failures)
        parts["i_parity"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["rates"] = codec_rates(png_roots[1], jpeg_root, turns)
        parts["ii"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["fit"], path = codec_fit(seed, have, turns, failures)
    parts["iii"] = time.perf_counter() - t0
    out["seconds"] = parts
    say(json.dumps({"codec": out}, default=str))
    return path


# phase 20: the public API on the card. (i) each family that FAMILIES, ZOO
# and ZOO2 build, at their kinds and sizes (the registry's sixteen names);
# (ii) a user's Builder network with the layers and Builder calls of ROADMAP
# item 10 and fault F1 at ShuffleNet-v1-g4's stage widths; (iii) the public
# ops.winograd.conv2d_winograd at RN50's first 3x3 shape
PUBLIC_FAMILIES = tuple(dict.fromkeys(
    [(arch, kind, IMAGE) for arch, kind in FAMILIES.items()] + list(ZOO) + list(ZOO2)))
PUBLIC_BATCH = 8  # (i): the bf16 eval forward of each family
PUBLIC_NET = "public_api_net"  # (ii): registered for this phase only
# ShuffleNet-v1-g4's stage widths (convnets_tpu/models/shufflenet_v1.py:20)
PUBLIC_WIDTHS = (272, 544, 1088)
PUBLIC_GROUPS = 4
PUBLIC_NET_IMAGE, PUBLIC_NET_BATCH, PUBLIC_NET_STEPS = 224, 64, 3  # (ii): bf16 Adam steps
# (ii)'s bar on the bf16 steps' losses, kernel path against the plain path
# with the same weights: phase 10's ceiling on a kernel-vs-plain loss (the
# fp32 step beside them is held to phase 14's bars, step_check)
PUBLIC_LOSS_BAR = TRAINER_MAX_BAR
PUBLIC_WINOGRAD = (256, 56, 64, 64, 1)  # (iii): N, H = W, Cin, Cout, pad (RN50's 56²×64)


def summary_modules(module):
    """The modules of nn.summarize's lines, in its order (pre-order over
    summary_children), each with its parent."""
    out = []

    def walk(mod, parent):
        out.append((mod, parent))
        for kid in mod.summary_children().values():
            walk(kid, mod)

    walk(module, None)
    return out


def printed_shapes(text):
    """The out=(...) shape of each layer line of a Model.summary text (the
    last " out=" of a line: a label may hold "out=" too)."""
    import ast

    return [ast.literal_eval(line.rsplit(" out=", 1)[1].split(")", 1)[0] + ")")
            for line in text.splitlines()[1:-1]]


def summary_check(arch, kind, image, seed, path, failures):
    """Phase 20 (i) for one family: built on the card (bf16, 10 classes,
    the setting's seeded init), one b8 eval forward with a forward hook on
    every module of its summary: each line's shape against the output the
    module produced (a fused ConvBNReLU's conv, BN and ReLU, which its fused
    forward does not call, against the site's output); Model.out_shape(8)
    against the logits; Model.num_params() against the parameters' numel
    and the summary's total line; the forward's launches against those
    read off its modules (model_launches), counted into `path`."""
    import torch

    from convnets_tpu_torch import nn
    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.settings import Settings

    label = f"{arch}{kind}@{image}"
    model = build_model(arch, Settings(kind=kind, input_size=(3, image, image),
                                       num_classes=ZOO_CLASSES, mixed_precision=True, seed=seed),
                        device=DEVICE)
    text = model.summary(batch_size=PUBLIC_BATCH)
    mods, shapes = summary_modules(model.module), printed_shapes(text)
    seen, hooks = {}, []
    for mod, _ in mods:
        hooks.append(mod.register_forward_hook(
            lambda m, i, o: seen.setdefault(id(m), []).append(tuple(o.shape))))
    x = torch.rand(PUBLIC_BATCH, image, image, 3, device=DEVICE,
                   generator=torch.Generator(device=DEVICE).manual_seed(seed))
    counts = {}
    with torch.inference_mode():
        logits = counted_run(lambda: model(x), counts)
    for h in hooks:
        h.remove()
    got = launches_of(counts)
    for k, v in counts.items():
        path[k] = path.get(k, 0) + v
    bad, fused = [], 0
    for (mod, parent), shape in zip(mods, shapes):
        if id(mod) in seen:
            if any(s != shape for s in seen[id(mod)]):
                bad.append(f"{mod.summary_label()}: printed {shape}, ran {seen[id(mod)]}")
        elif isinstance(parent, nn.ConvBNReLU) and id(parent) in seen:
            fused += 1
            if seen[id(parent)][0] != shape:
                bad.append(f"{mod.summary_label()} in a fused site: printed {shape}, the site "
                           f"ran {seen[id(parent)][0]}")
        else:
            bad.append(f"{mod.summary_label()}: printed {shape}, never ran")
    total = text.splitlines()[-1]
    n_params = sum(p.numel() for p in model.parameters())
    counts_ok = (model.num_params() == n_params
                 and total.startswith(f"total params: {n_params:,}   total state: ")
                 and model.out_shape(PUBLIC_BATCH) == tuple(logits.shape)
                 and len(mods) == len(shapes) and bool(torch.isfinite(logits).all()))
    ok = counts_ok and not bad and got == model_launches(model)[0]
    say(f"(i) {label}: {len(shapes)} summary lines, {len(shapes) - fused} against the module's "
        f"own output, {fused} inside fused sites; out_shape {model.out_shape(PUBLIC_BATCH)} vs "
        f"logits {tuple(logits.shape)}; num_params {model.num_params():,} vs numel {n_params:,} "
        f"and '{total}'; forward launches {launches_summary(got)} "
        f"{'ok' if ok else 'FAIL'}" + "".join(f"\n    {b}" for b in bad[:4]))
    if not ok:
        failures.append(f"public API (i) {label}: shapes {bad[:4]}, counts {counts_ok}, "
                        f"launches {launches_summary(got)}")
    return {"lines": len(shapes), "fused_lines": fused, "params": n_params,
            "launches": launches_summary(got)}


def build_public_net(setting):
    """A user's network written as template_net.py shows, with the names
    this slice ports: the max-pool stem, ShuffleNet-v1-g4's stage widths, a
    grouped (g = 4) 1x1 conv_block and nn.ChannelShuffle(4), an nn.Concat of
    two bare b.conv(..., set_output=False) branches after which in_channels
    is set to their sum (as InceptionNet-v1 does with conv_block), a
    depthwise block whose groups come from in_channels, nn.Sigmoid, a
    grouped 1x1 to the last width. tests/test_torch_summary.py holds a
    narrower one against its JAX twin."""
    from convnets_tpu_torch import nn
    from convnets_tpu_torch.models.base import Builder, Model

    w1, w2, w3 = PUBLIC_WIDTHS
    g = PUBLIC_GROUPS
    b = Builder(setting)
    layers = [b.conv_block(24, kernel=3, stride=2, padding=1),
              nn.MaxPool2d(3, stride=2, padding=1),
              b.conv_block(w1, kernel=1),
              b.conv_block(w1, kernel=1, groups=g),                         # row 1g / 5g
              nn.ChannelShuffle(g),
              nn.Concat([b.conv(w1, kernel=1, set_output=False),
                         b.conv(w2 - w1, kernel=3, padding=1, set_output=False)])]
    b.in_channels = w2
    layers += [b.conv_block_depthwise(stride=2, padding=1),                # row 9
               nn.Sigmoid(),
               b.conv_block(w3, kernel=1, groups=g),                        # row 1g / 5g
               nn.GlobalAvgPool2d(),
               b.linear(setting.num_classes)]
    return Model("PublicApiNet", setting, nn.Sequential(layers))


def public_net_check(seed, failures, step_path, fwd_path):
    """Phase 20 (ii): the Builder network (build_public_net) at 224², 10
    classes, BN on. (a) phase 14's step check: the fp32 SGD step at b8,
    kernel vs plain path, beside its control (step_check). (b) PUBLIC_NET_STEPS
    bf16 Adam steps at b64 on the kernels, each step's launches exact
    (model_launches) with the grouped ones on the routes grouped_plan gives
    (wgmma_wide) and the window kernels on the vector route, counted into
    `step_path`; the same steps of the same network with its weights copied,
    on the plain path; every step's loss within PUBLIC_LOSS_BAR of the
    plain path's, the kernel path's loss falling. (c) one eval forward
    through the custom ops: fp32 b8 logits against the plain path's within
    ZOO_FP32_TOL × max|logit|, and the trained bf16 model's served b64 uint8
    request (counted into `fwd_path`, its launches and grouped routes exact)
    against the plain path's: argmax agreement ≥ ARGMAX_MIN."""
    import torch

    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.serve import ServingModel

    n, image = PUBLIC_NET_BATCH, PUBLIC_NET_IMAGE
    label = f"{PUBLIC_NET}@{image}"
    res = {}
    res["step"] = step_check(label, seed, failures, batch=ZOO_BATCH, image=image,
                             classes=ZOO_CLASSES,
                             make=lambda **kw: zoo_model(PUBLIC_NET, "0", image, seed, **kw))
    models = {p: zoo_model(PUBLIC_NET, "0", image, seed, dropout_rate=0.0)
              for p in ("kernel", "plain")}
    models["plain"].load_state_dict(models["kernel"].state_dict())
    want_fwd, want_step = model_launches(models["kernel"])
    routes_fwd, routes_step = grouped_routes_want(models["kernel"])
    rng = np.random.default_rng(seed + 20)
    x = torch.from_numpy(rng.integers(0, 256, (n, image, image, 3), dtype=np.uint8)).to(DEVICE)
    y = torch.from_numpy(rng.integers(0, ZOO_CLASSES, n)).to(DEVICE)
    losses, steps_ok = {}, True
    for path in ("plain", "kernel"):
        state, step = train_state(models[path], norm=True, stats=IMAGENET_STATS)
        losses[path] = []
        with plain_kernels() if path == "plain" else contextlib.nullcontext():
            for i in range(PUBLIC_NET_STEPS):
                counts = {}
                losses[path].append(float(counted_run(lambda: step(state, x, y)[0], counts)))
                if path == "kernel":
                    got = launches_of(counts)
                    fine = got == want_step and grouped_routes() == routes_step
                    if i == 0:
                        check_routes(f"(ii) {label} bf16 step", got, failures)
                        say(f"(ii) {label}: launches per bf16 b{n} Adam step "
                            f"{launches_summary(got)}, grouped per route {grouped_routes()} "
                            f"(expected {launches_summary(want_step)}, {routes_step}) "
                            f"{'ok' if fine else 'FAIL'}")
                    steps_ok &= fine
                    for k, v in counts.items():
                        step_path[k] = step_path.get(k, 0) + v
    rel = [abs(k - p) / abs(p) for k, p in zip(losses["kernel"], losses["plain"])]
    falls = losses["kernel"][-1] < losses["kernel"][0] and all(np.isfinite(losses["kernel"]))
    ok = steps_ok and falls and max(rel) <= PUBLIC_LOSS_BAR
    say(f"(ii) {label}: {PUBLIC_NET_STEPS} bf16 Adam steps (b{n}, lr {ZOO_LEARN_LR:g}), loss "
        f"kernel {[round(v, 5) for v in losses['kernel']]}, plain (weights copied) "
        f"{[round(v, 5) for v in losses['plain']]}: worst rel {max(rel):.3e} (bar "
        f"{PUBLIC_LOSS_BAR:g}), falls {falls}, every step's launches exact {steps_ok} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"public API (ii) bf16 steps: rel {rel}, falls {falls}, launches {steps_ok}")
    res.update(losses=losses, loss_rel=rel)

    model32 = zoo_model(PUBLIC_NET, "0", image, seed, mixed_precision=False)
    x32 = torch.rand(ZOO_BATCH, image, image, 3, device=DEVICE,
                     generator=torch.Generator(device=DEVICE).manual_seed(seed + 21))
    with torch.inference_mode():
        y32 = model32(x32)
        with plain_kernels():
            r32 = model32(x32)
    rel32 = float((y32 - r32).abs().max() / r32.abs().max())
    ok32 = rel32 <= ZOO_FP32_TOL and bool(torch.isfinite(y32).all())
    del model32
    model = models["kernel"].eval()
    server = ServingModel(model, input_dtype="uint8", stats=IMAGENET_STATS)
    req = rng.integers(0, 256, (n, image, image, 3), dtype=np.uint8)
    server(req)  # warm: the plans of the request's shapes
    counts = {}
    got = counted_run(lambda: server(req), counts)
    fwd_launches, fwd_routes = launches_of(counts), grouped_routes()
    with plain_kernels():
        ref = server(req)
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    fine = (ok32 and agree >= ARGMAX_MIN and bool(torch.isfinite(got).all())
            and fwd_launches == want_fwd and fwd_routes == routes_fwd)
    say(f"(ii) {label}: fp32 b{ZOO_BATCH} eval logits vs plain: max |Δ| / max |logit| "
        f"{rel32:.3e} (tol {ZOO_FP32_TOL:g}); served bf16 b{n} uint8 request vs plain: argmax "
        f"agreement {agree:.4f} (min {ARGMAX_MIN}), max |Δlogit| "
        f"{float((got - ref).abs().max()):.4e} of max |logit| {float(ref.abs().max()):.4e}; "
        f"launches {launches_summary(fwd_launches)}, grouped per route {fwd_routes} (expected "
        f"{launches_summary(want_fwd)}, {routes_fwd}) {'ok' if fine else 'FAIL'}")
    if not fine:
        failures.append(f"public API (ii) eval: fp32 rel {rel32:.3e}, argmax {agree:.4f}, "
                        f"launches {launches_summary(fwd_launches)}, routes {fwd_routes}")
    for k, v in counts.items():
        fwd_path[k] = fwd_path.get(k, 0) + v
    res.update(fp32_logits_rel=rel32, served_argmax_agreement=agree,
               launches_step=launches_summary(want_step),
               launches_forward=launches_summary(fwd_launches))
    del models, model, server, state
    return res


def public_winograd_check(seed, failures, path):
    """Phase 20 (iii): ops.winograd.conv2d_winograd, the public entry, at
    RN50's 56²×64 at b256 in bf16, m = 4 and 2, its calls counted into
    `path` (one winograd_input and one winograd_output each): with a bias
    against conv2d_winograd_plain on the same inputs within phase 18's
    kernel bar (CONV_TOL), without one against the fp32 direct conv within
    phase 18's error band (WINOGRAD_BAND), and device ms of both beside the
    plain composition's; a 5x5 weight raises ValueError on the card too."""
    import torch

    from convnets_tpu_torch.ops import kernels, winograd

    n, h, cin, cout, p = PUBLIC_WINOGRAD
    g = torch.Generator(device=DEVICE).manual_seed(seed + 22)
    x32 = torch.randn(n, h, h, cin, device=DEVICE, generator=g)
    w32 = torch.randn(3, 3, cin, cout, device=DEVICE, generator=g) / np.sqrt(9 * cin)
    x, w = x32.bfloat16(), w32.bfloat16()
    b = (0.1 * torch.randn(cout, device=DEVICE, generator=g)).bfloat16()
    # phase 18's oracle: the direct conv of the fp32 draws, before their rounding to bf16
    oracle = kernels.conv2d_fused(x32, w32, padding=p)
    direct = kernels.conv2d_fused(x, w, padding=p)
    del x32, w32
    atol, rtol = CONV_TOL["bfloat16"]
    out = {}
    for m in (4, 2):
        counts = {}
        got, got_nb = counted_run(lambda: (winograd.conv2d_winograd(x, w, b, padding=p, m=m),
                                           winograd.conv2d_winograd(x, w, padding=p, m=m)),
                                  counts)
        ref = winograd.conv2d_winograd_plain(x, w, b, padding=p, m=m)
        err = float((got.float() - ref.float()).abs().max())
        band, band_direct = winograd_band(got_nb, direct, oracle)
        launched = {k: v for k, v in counts.items() if v}
        ok = (within(got, ref, atol, rtol) and bool(torch.isfinite(got).all())
              and band < WINOGRAD_BAND[m] * max(band_direct, 1e-3) and band < WINOGRAD_BAND_MAX
              and launched == {"winograd_input": 2, "winograd_output": 2})
        del ref, got, got_nb
        ms = time_ms(lambda: winograd.conv2d_winograd(x, w, b, padding=p, m=m), REPS)
        plain_ms = time_ms(lambda: winograd.conv2d_winograd_plain(x, w, b, padding=p, m=m), REPS)
        say(f"(iii) conv2d_winograd b{n} bf16 {h}x{h} {cin}->{cout} F({m},3): vs plain max |Δ| "
            f"{err:.3e} (tol {atol:g}+{rtol:g}|ref|); no bias vs the fp32 direct conv: band "
            f"{band:.3e} vs direct bf16 {band_direct:.3e} (< {WINOGRAD_BAND[m]:g}× and "
            f"{WINOGRAD_BAND_MAX:g}); launches {launched}; {ms:.4f} ms (plain {plain_ms:.4f}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"public API (iii) conv2d_winograd m={m}: err {err:.3e}, band "
                            f"{band:.3e} / {band_direct:.3e}, launches {launched}")
        for k, v in counts.items():
            path[k] = path.get(k, 0) + v
        out[f"m{m}"] = {"err_vs_plain": err, "band": band, "band_direct": band_direct, "ms": ms,
                        "plain_ms": plain_ms}
    try:
        winograd.conv2d_winograd(x, torch.zeros(5, 5, cin, cout, device=DEVICE,
                                                dtype=torch.bfloat16), padding=2)
        refused = False
    except ValueError:
        refused = True
    say(f"(iii) conv2d_winograd with a 5x5 weight on the card raises ValueError: "
        f"{'ok' if refused else 'FAIL'}")
    if not refused:
        failures.append("public API (iii): a 5x5 weight did not raise")
    return out


def phase_public_api(seed, card, failures):
    """Phase 20: the public API on the card, (i) summary_check over
    PUBLIC_FAMILIES, (ii) public_net_check, (iii) public_winograd_check.
    Prints the public_api JSON line; returns the path's launches per
    kernels-line entry: the eval forwards' (i, ii) and the bf16 steps' (ii)
    kernels, the trainable functions by their kernels, and (iii)'s
    transforms."""
    fwd, step, wino, parts, out = {}, {}, {}, {}, {"card": card}
    t0 = time.perf_counter()
    out["families"] = {f"{arch}{kind}@{image}": summary_check(arch, kind, image, seed, fwd,
                                                              failures)
                       for arch, kind, image in PUBLIC_FAMILIES}
    parts["i"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with registered(PUBLIC_NET, build_public_net):
        out["builder_net"] = public_net_check(seed, failures, step, fwd)
    parts["ii"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["conv2d_winograd"] = public_winograd_check(seed, failures, wino)
    parts["iii"] = time.perf_counter() - t0
    out["seconds"] = parts
    path = {k: fwd.get(k, 0) for k in ("conv2d_fused", "grouped_conv2d_fused", "depthwise_conv2d",
                                        "max_pool2d", "avg_pool2d")}
    path.update({k: step.get(k, 0) for k in ("conv2d_stats", "conv2d_stats_reduce",
                                             "grouped_conv2d_stats", "bn_act_forward",
                                             "pool2d_backward")})
    path.update(bn_act_backward=step.get("bn_act_backward_apply", 0),
                conv_bn_relu_train=step.get("conv2d_stats", 0),
                conv_bn_relu_train_grouped=step.get("grouped_conv2d_stats", 0),
                conv2d_train=step.get("conv2d_fused", 0),
                depthwise_train=step.get("depthwise_conv2d", 0),
                pool2d_train=step.get("max_pool2d", 0),
                winograd_input=wino.get("winograd_input", 0),
                winograd_output=wino.get("winograd_output", 0))
    out["launches"] = path
    say(f"public_api path: launches {path}")
    say(json.dumps({"public_api": out}, default=str))
    return path


# the paths of phases 10-20 whose launches the kernels line carries as
# <path>_launches beside the main path's
PATHS = ("trainer", "artifact", "augmented_fit", "cli", "zoo", "graphed_epoch", "chunked_epoch",
         "zoo2", "fused_densenet", "remat_debug_feed", "adaptive_pool", "data_parallel",
         "envelope", "winograd_vgg_cli", "decoded_fit", "public_api")
SOURCES = {  # kernel: (source, TPU kernel it replaces)
    "conv2d_fused": ("convnets_tpu_torch/csrc/conv_wgmma.cu", "convnets_tpu/ops/pallas/conv.py:391"),
    "max_pool2d": ("convnets_tpu_torch/csrc/pool.cu", "convnets_tpu/ops/pallas/pool.py:88"),
    "avg_pool2d": ("convnets_tpu_torch/csrc/pool.cu", "convnets_tpu/ops/pallas/pool.py:94"),
    "conv2d_stats": ("convnets_tpu_torch/csrc/conv_wgmma.cu", "convnets_tpu/ops/pallas/conv.py:543"),
    "conv2d_stats_reduce": ("convnets_tpu_torch/csrc/conv_fused.cu",
                            "convnets_tpu/ops/pallas/conv.py:543"),
    "conv_bn_relu_train": ("convnets_tpu_torch/ops/kernels/fused.py",
                           "convnets_tpu/ops/pallas/fused.py:35"),
    "bn_act_forward": ("convnets_tpu_torch/csrc/bn_act.cu", "convnets_tpu/ops/pallas/fused.py:49"),
    "bn_act_backward": ("convnets_tpu_torch/csrc/bn_act.cu", "convnets_tpu/ops/pallas/fused.py:70"),
    "conv2d_train": ("convnets_tpu_torch/ops/kernels/conv.py", "convnets_tpu/ops/pallas/conv.py:675"),
    "pool2d_train": ("convnets_tpu_torch/ops/kernels/pool.py", "convnets_tpu/ops/pallas/pool.py:100"),
    "pool2d_train_avg": ("convnets_tpu_torch/ops/kernels/pool.py",
                         "convnets_tpu/ops/pallas/pool.py:100"),
    "pool2d_backward": ("convnets_tpu_torch/csrc/pool.cu", "convnets_tpu/ops/pallas/pool.py:111"),
    "depthwise_conv2d": ("convnets_tpu_torch/csrc/depthwise.cu",
                         "convnets_tpu/ops/pallas/conv.py:755"),
    "depthwise_train": ("convnets_tpu_torch/ops/kernels/depthwise.py",
                        "convnets_tpu/ops/pallas/conv.py:702"),
    "grouped_conv2d_fused": ("convnets_tpu_torch/csrc/conv_wgmma.cu",
                             "convnets_tpu/ops/pallas/conv.py:391"),
    "grouped_conv2d_stats": ("convnets_tpu_torch/csrc/conv_wgmma.cu",
                             "convnets_tpu/ops/pallas/conv.py:543"),
    "grouped_conv2d_train": ("convnets_tpu_torch/ops/kernels/conv.py",
                             "convnets_tpu/ops/pallas/conv.py:647"),
    "conv_bn_relu_train_grouped": ("convnets_tpu_torch/ops/kernels/fused.py",
                                   "convnets_tpu/ops/pallas/fused.py:35"),
    "bottleneck_block": ("convnets_tpu_torch/csrc/block_wgmma.cu",
                         "convnets_tpu/ops/pallas/block.py:122"),
    # no Pallas kernel: the transform stages of the einsum composition
    "winograd_input": ("convnets_tpu_torch/csrc/winograd.cu", "convnets_tpu/ops/winograd.py:149"),
    "winograd_output": ("convnets_tpu_torch/csrc/winograd.cu",
                        "convnets_tpu/ops/winograd.py:162"),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of weights and data")
    ap.add_argument("--phases", default=None,
                    help="run only these phases (comma-separated, e.g. 6b,7), print no "
                         "kernels line and no result line: a development aid")
    ap.add_argument("--serve-rate", default=None, metavar="ROOT",
                    help="print the RN50@224 serving img/s of the live ServingModel of the "
                         "checkout at ROOT and exit, with no result line: run it over two "
                         "checkouts in turns (parent, change, change, parent) to compare them")
    ap.add_argument("--train-profile", default=None, metavar="ROOT",
                    help="print the RN50@224 bf16 b256 train step's ms and profiled device "
                         "split (BN passes of the fused sites apart), the RN26@32 b256 "
                         "step's img/s, the grouped fused sites' times, ShuffleNet-v1-g4@224's "
                         "b256 step and request (device ms, the grouped kernels by name) and "
                         "the world-of-one mesh's profile of the checkout at ROOT and exit, "
                         "with no result line; run it over two checkouts in turns as "
                         "--serve-rate")
    args = ap.parse_args()

    sys.path.insert(0, os.path.abspath(args.serve_rate or args.train_profile or HERE))
    try:
        import torch
        from convnets_tpu_torch.ops import kernels
    except ImportError as e:
        die(f"cannot import the port ({e}); run from the repository root")

    # phase 0: device
    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        die(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say(f"device: {kind} (count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    say(card)

    if args.serve_rate:
        kernels.lib()
        say(json.dumps({"serve_rate": {"root": os.path.abspath(args.serve_rate), "card": card,
                                       **serve_rate(args.seed)}}))
        return
    if args.train_profile:
        kernels.lib()
        say(json.dumps({"train_profile": {"root": os.path.abspath(args.train_profile),
                                          "card": card, **train_profile(args.seed)}}))
        return

    # phase 1: build
    t_all = t0 = time.perf_counter()
    log = kernels.build(verbose=True)
    kernels.lib()
    say(f"build: {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if ("registers" in line or "spill" in line or "Compiling entry" in line
                or "warning" in line.lower()):
            say("  ptxas: " + line.strip())

    failures = []
    sass_check(failures)
    from convnets_tpu_torch.models import build_model

    summary, serve, train, nobn = {}, {}, {}, {}
    state = {}

    def probe():
        if "probe" not in state:
            state["probe"] = build_model("resnet", model_setting("resnet", args.seed, True),
                                         device=DEVICE)
        return state["probe"]

    def phase_5():
        step_check("resnet", args.seed, failures)
        state["served"] = learn_check("resnet", args.seed, failures)
        nobn["resnet"] = nobn_check("resnet", args.seed, failures)
        train["resnet"] = train_throughput("resnet", args.seed, failures)[0]

    def phase_3():
        serve["resnet"] = serve_check(state.pop("served"), "resnet", args.seed, SERVE_BATCHES,
                                      failures)

    def phase_7():
        serve["mobilenet_v1"], train["mobilenet_v1"] = phase_family("mobilenet_v1", args.seed,
                                                                    failures)
        serve["densenet"], train["densenet"] = phase_family("densenet", args.seed, failures,
                                                            DN121_TURNS)

    def phase_8():
        summary.update(phase_grouped_kernels(failures))
        block_summary, state["block"] = phase_block(failures)
        summary.update(block_summary)

    def phase_9():
        serve["resnext"], train["resnext"] = phase_family("resnext", args.seed, failures)
        nobn["resnext"] = nobn_check("resnext", args.seed, failures)

    def phase_10():
        fit, train_calls = phase_trainer(args.seed, card, summary, failures)
        # each kernel's launches in phase 10's fit, counted as the kernels
        # line counts them (the trainable functions by their kernels)
        state["trainer"] = {"conv2d_fused": fit["conv2d_fused"], "max_pool2d": fit["max_pool2d"],
                            "conv2d_stats": fit["conv2d_stats"],
                            "conv2d_stats_reduce": fit["conv2d_stats_reduce"],
                            "conv_bn_relu_train": fit["conv2d_stats"],
                            "bn_act_forward": fit["bn_act_forward"],
                            "bn_act_backward": fit["bn_act_backward_apply"],
                            "pool2d_train": sum(c["max_pool2d"] for c in train_calls),
                            "pool2d_backward": fit["pool2d_backward"]}

    def phase_11():
        served, fit, fit_calls = phase_artifact(args.seed, card, failures)
        # each kernel's launches on phase 11's two paths: the artifact's b256
        # request and the augmented fit (the trainable functions by their
        # kernels)
        state["artifact"] = {"conv2d_fused": served["conv2d_fused"],
                             "max_pool2d": served["max_pool2d"]}
        state["augmented_fit"] = {"conv2d_fused": fit["conv2d_fused"],
                                  "max_pool2d": fit["max_pool2d"],
                                  "conv2d_stats": fit["conv2d_stats"],
                                  "conv2d_stats_reduce": fit["conv2d_stats_reduce"],
                                  "conv_bn_relu_train": fit["conv2d_stats"],
                                  "bn_act_forward": fit["bn_act_forward"],
                                  "bn_act_backward": fit["bn_act_backward_apply"],
                                  "pool2d_train": sum(c["max_pool2d"] for c in fit_calls),
                                  "pool2d_backward": fit["pool2d_backward"]}

    def phase_12():
        zoo = phase_zoo(args.seed, card, summary, failures)
        cli, state["cli"], state["zoo"] = phase_cli(args.seed, card, failures)
        say(json.dumps({"cli": {"card": card, "zoo": zoo, **cli}}))

    def phase_13():
        state["graphed_epoch"], state["chunked_epoch"] = phase_graph(args.seed, card, failures)

    def phase_14():
        state["zoo2"] = phase_zoo2(args.seed, card, summary, failures)

    def phase_15():
        state.update(phase_last_modules(args.seed, card, summary, failures))

    def phase_16():
        state["data_parallel"] = phase_data_parallel(args.seed, card, failures)

    def phase_17():
        state["envelope"] = phase_envelope(args.seed, card, summary, failures)

    def phase_18():
        rn50, cli = phase_winograd(args.seed, card, summary, failures)
        state["winograd_rn50"] = rn50
        # each kernel's launches on the gated VGG-16@32 CLI path (the
        # trainable functions by their kernels)
        state["winograd_vgg_cli"] = {
            "winograd_input": cli["winograd_input"], "winograd_output": cli["winograd_output"],
            "conv2d_stats_reduce": cli["conv2d_stats_reduce"],
            "conv_bn_relu_train": cli["bn_act_forward"], "bn_act_forward": cli["bn_act_forward"],
            "bn_act_backward": cli["bn_act_backward_apply"], "max_pool2d": cli["max_pool2d"],
            "pool2d_backward": cli["pool2d_backward"]}

    def phase_19():
        state["decoded_fit"] = phase_codec(args.seed, card, failures)

    def phase_20():
        state["public_api"] = phase_public_api(args.seed, card, failures)

    phases = {
        "2a": lambda: phase_conv_plans(failures),
        "2": lambda: summary.update(phase_kernels(probe(), failures)),
        "4": lambda: summary.update(phase_train_kernels(probe(), failures)),
        "4b": lambda: phase_b256_conv(probe(), summary),
        "4c": lambda: phase_bn_act(probe(), summary, failures),
        "5": phase_5,
        "3": phase_3,
        "6": lambda: (summary.update(phase_zoo_kernels(failures)),
                      phase_window_routes(summary, failures)),
        "6b": lambda: phase_b256_windows(summary),
        "7": phase_7,
        "8": phase_8,
        "8b": lambda: phase_b256_grouped(summary),
        "9": phase_9,
        "10": phase_10,
        "11": phase_11,
        "12": phase_12,
        "13": phase_13,
        "14": phase_14,
        "15": phase_15,
        "16": phase_16,
        "17": phase_17,
        "18": phase_18,
        "19": phase_19,
        "20": phase_20,
    }
    chosen = list(phases) if args.phases is None else args.phases.split(",")
    if any(p not in phases for p in chosen) or ("3" in chosen and "5" not in chosen):
        die(f"--phases: a comma-separated subset of {','.join(phases)} (3 needs 5)")
    for name in phases:
        if name in chosen:
            t0 = time.perf_counter()
            phases[name]()
            if name == "4c":
                state.pop("probe", None)  # RN50's probe model is not needed later
            say(f"[phase {name}: {time.perf_counter() - t0:.1f} s]")
    say(f"[all phases: {time.perf_counter() - t_all:.1f} s]")
    if args.phases is not None:  # a development run: no kernels line, no result
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        sys.exit(1 if failures else 0)

    # launches, each from the path that runs the kernel: serving (rows 1, 2,
    # 3, 9 and the grouped forward), the b256 train runs (rows 4, 5, 6, 9's
    # depthwise_train, the grouped statistics), the batch_norm=False steps
    # (rows 7 and 8) and the block A/B (row 10)
    launches = {"conv2d_fused": serve["resnet"]["conv2d_fused"],
                "max_pool2d": serve["resnet"]["max_pool2d"],
                "avg_pool2d": serve["densenet"]["avg_pool2d"],
                "conv2d_stats": train["resnet"]["conv2d_stats"],
                "conv2d_stats_reduce": train["resnet"]["conv2d_stats_reduce"],
                "conv_bn_relu_train": train["resnet"]["conv2d_stats"],
                "bn_act_forward": train["resnet"]["bn_act_forward"],
                "bn_act_backward": train["resnet"]["bn_act_backward_apply"],
                "pool2d_train": train["resnet"]["max_pool2d"],
                "pool2d_train_avg": train["densenet"]["avg_pool2d"],
                "pool2d_backward": train["resnet"]["pool2d_backward"],
                "conv2d_train": nobn["resnet"]["conv2d_fused"],
                "depthwise_conv2d": serve["mobilenet_v1"]["depthwise_conv2d"],
                "depthwise_train": train["mobilenet_v1"]["depthwise_conv2d"],
                "grouped_conv2d_fused": serve["resnext"]["grouped_conv2d_fused"],
                "grouped_conv2d_stats": train["resnext"]["grouped_conv2d_stats"],
                "grouped_conv2d_train": nobn["resnext"]["grouped_conv2d_fused"],
                "conv_bn_relu_train_grouped": train["resnext"]["grouped_conv2d_stats"],
                "bottleneck_block": state["block"],
                "winograd_input": state["winograd_rn50"]["winograd_input"],
                "winograd_output": state["winograd_rn50"]["winograd_output"]}
    for name in SOURCES:
        if launches[name] <= 0:
            failures.append(f"{name}: no launch on its main path")
    for path in PATHS:
        for name, count in state[path].items():
            if count <= 0:
                failures.append(f"{name}: no launch on phase 10-20's {path} path")
    say(card)
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": summary[name]["err"],
         "ms": summary[name]["ms"], "plain_ms": summary[name]["plain_ms"],
         "bound_ms": summary[name]["bound_ms"],
         "bound_by": ("operations" if summary[name]["ops_ms"] >= summary[name]["bytes_ms"]
                      else "bytes"),
         "library_ms": summary[name]["library_ms"],
         **{f"{path}_launches": state[path][name] for path in PATHS if name in state[path]},
         **{k: summary[name][k] for k in B256_KEYS + (PLAIN_B256, LOOP_B256) + SIMT_KEYS
            + ZOO2_KEYS + ZOO2_224_KEYS + BN_KEYS + ROUTE_KEYS + ENVELOPE_KEYS + WINOGRAD_KEYS
            + ("serving_ms",)
            if k in summary[name]}}
        for name, (src, rep) in SOURCES.items()]}))
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        sys.exit(1)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
