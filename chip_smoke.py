#!/usr/bin/env python3
"""Drive the PyTorch port's AI-DEAL training, TE-augmentation training,
AI-DEAL serving, magnitude training, Mag serving, VET-Net serving,
supervised training with 2D-Net serving, the other TE-augmentation
generators, AI-DEAL's uncertainty path (UQ training, σ-calibration,
PDFF-var serving), the single-subject trainer, the trainers' options, the
run record (settings, summaries, checkpoints, preemption, TrainLoop), the
ROI evaluation (in-vivo ROI bias, the vial phantom), the PI-VAE/GAN
trainer, the latent-diffusion family (training, dataset generation, the
generative metrics), scanner files in and out (DICOM and NIfTI series
folders, DICOM export) and the multi-device paths (the sharded serving fit,
data-parallel training over `torch.distributed`, the launcher, the serving
split) and the rest of the package (the Bayesian decoders, the
discriminators, the gradient penalty, the complex U-Net, the InceptionV3
features, the gradient-flow check, the NaN sanitizer) on an NVIDIA card
(every card of the host for the multi-device paths; with one card, the
same card twice).

    python3 chip_smoke.py

Phases, each printing one JSON line (no phase catches its own failure; any
error or mismatch ends the run with a non-zero exit and no `ok` line):

1. env      torch / CUDA versions, the card's name and power limit.
2. build    compiles every kernel of `ideal_gan_tpu_torch/csrc/` with nvcc
            (one process per source, in parallel) and prints the seconds
            and the ptxas register / spill report.
3. kernels  each kernel at the main paths' shapes against its plain PyTorch
            version on the same inputs (TF32 off), with CUDA-event times of
            both (and, for the per-voxel physics kernels, whose ~0.05 ms
            is below the host's launch gap, the kernel's device time from
            torch.profiler) and the card's lower bound for the same work:
            - map fit: the serving call (MEBCRN, nb=8), the teaug WF_loss
              call (MEBCRN, nb=8, a jittered TE, per-echo form) and planar
              buffers at nb=8 and nb=128 in f32, bf16 echoes, and bf16
              echoes with bf16 rho; accuracy guard against the synthetic
              ground truth (max err < 5e-2) and the bf16 PDFF gate (< 3e-3);
            - ConvLSTM forward (3xTF32 on the tensor cores): Cin=2 and
              Cin=1, F=36, VET-Net's width Cin=2, F=72, and the 2U-Net R2*
              net's Cin=1, F=72, each at ne=6, nb=8; the single-subject
              trainer's Cin=1, F=36, nb=3; and the UQ calibration stage's
              Cin=2 and Cin=1, F=36, nb=6; each against the plain version
              in float32 and float64, two
              launches bit for bit, device time beside the 3xTF32 and FP32
              bounds, and its HMMA instruction count (see
              `convlstm_entry`);
            - IDEAL cycle: the training call (MEBCRN, nb=8, 384², ne=6) with
              the per-row TE test and with the forced uniform recurrence;
            - ConvLSTM backward: Cin=2 and Cin=1, F=36, Cin=2, F=72 and
              Cin=1, F=72, each at ne=6, nb=8, and Cin=1, F=36 at the
              single-subject trainer's nb=3, dx, dk and db against
              `convlstm_backward_reference` in float64 and float32, on
              inputs that keep clear of leaky_relu's kink on either side of
              it and on random ones, two launches bit for bit, the call
              split into the state recompute and the 3xTF32 echo sweep's
              stages, and the HMMA instructions `cuobjdump -sass` finds in
              the stages' kernels (see `convlstm_bwd_entry`);
            - forward synthesis: the TE-augmentation call (MEBCRN maps with
              some R2* < 0, nb=8, 384², ne=6) at a jittered TE train
              (per-echo form, and the per-row test) and at a uniform one
              (forced recurrence, and the per-row test);
            - magnitude fit: the magnitude trainer's and Mag serving's call
              (|S| (nb, ne, H, W, 1), R2* in channel 0, nb=8, 384², ne=6)
              at a uniform TE train (per-row test, and the forced
              recurrence) and at a jittered one (per-row test, and the
              per-echo form), each output held to the JAX package's
              rtol 1e-3 / atol 5e-4, with the count of voxels beyond
              1e-5 + 1e-4·|plain| reported.
4. train    `ideal_gan_tpu_torch.cli.train_unsup.main` with --out_vars PM
            on 16 synthetic 384² slices at batch 8 for 2 epochs (AI-DEAL,
            F=36, seeded random weights), with every launch counter set to 0
            just before and read just after; fails unless the cycle, the
            ConvLSTM backward and forward kernels ran (at least 8, 8 and 96
            launches), every loss is finite and every ConvLSTM parameter of
            both nets has a non-zero gradient. Then one FM step and one R2
            step on the card (TF32 off) and on the CPU from the same weights
            and batch (F=36, 192², batch 2, the synthetic cohort with
            1e-3 noise; see `step_parity`): loss and every gradient leaf
            compared. A witness repeats the FM step on the noise-free
            cohort on the card with the kernels and with the plain
            ConvLSTM, and on the CPU: its loss and module outputs are held,
            and it reports where the card's gradients leave the CPU's.
4b. io     scanner files at full size (see `io_phase`): 16 synthetic
            384² slices (12 echoes) written as 2 subjects' MECSE DICOM
            series folders (192 files: 6 echoes, magnitude and phase, the
            port's `DicomDataset`) and BIDS NIfTI sets (48 volumes); the
            DICOM loader's native parser (built with g++ into `_build/`)
            and Python walk bit-equal and within the uint16 quantisation
            bound of the source, with their host seconds and the parse
            alone; the NIfTI loader ≤ 1e-6 from its expected values;
            `cli.train_unsup --train_data DICOM` and `NIFTI` (1 epoch, 2
            step pairs, F=36, batch 8), counted (the cycle and both
            ConvLSTM kernels at the train phase's rate), finite, on
            exactly the loader's cohort; `cli.infer --model_sel AI-DEAL
            --export dicom,npz` on the DICOM run, counted, every PDFF and
            R2s pixel read back equal to uint16(255·clip(map, 0, 1)) of
            the npz; item 9's physics (the bipolar synthesis → fit round
            trip, `acq_demod`, the fatty-acid model, `compat.acq_to_acq`
            and the legacy `get_rho`) card vs CPU (TF32 off) within 1e-5 +
            1e-4·|CPU|.
5. teaug    `ideal_gan_tpu_torch.cli.train_teaug.main` on 16 synthetic
            384² slices at batch 8 for 2 epochs (VET-Net, F=72, seeded
            random weights), with every launch counter set to 0 just before
            and read just after; fails unless the synthesis kernel ran once
            a step and the ConvLSTM forward and backward and the fit kernel
            (the WF_loss diagnostic) at least once a step, every loss is
            finite and every ConvLSTM and TEEncoder parameter has a non-zero
            gradient. Then one generator step on the card (TF32 off) and on
            the CPU from the same weights, maps, TE train and noise (F=72,
            96², batch 2; see `teaug_step_parity`): loss and every gradient
            leaf compared, and every metric (WF_loss, the fit kernel's
            diagnostic, included); witnesses: the card step with the plain
            ConvLSTM, both steps against a float64 CPU step, and a trace of
            both (see `teaug_step_parity`).
6. e2e      `ideal_gan_tpu_torch.cli.infer.main` on 16 synthetic 384²
            slices at batch 8 (AI-DEAL, F=36, seeded random weights), with
            every launch counter set to 0 just before and read just after;
            fails unless the fit and ConvLSTM forward kernels ran (at least
            2 fit and 24 ConvLSTM launches) and every map is finite. Then the
            first chunk again on the card (TF32 off) and on the CPU with the
            same weights, maps and PDFF compared.
7. mag      `ideal_gan_tpu_torch.cli.train_mag.main` on 16 synthetic 384²
            slices at batch 8 for 2 epochs (F=36, the JAX `DEFAULTS`:
            supervised, MSE on R2*, TE input, self-attention), then one
            unsupervised step (the magnitude cycle loss), each with every
            launch counter set to 0 just before and read just after; fails
            unless the magnitude fit and synthesis kernels ran once a step
            and the ConvLSTM forward and backward at least once a step,
            and every loss is finite. Then one step of each config on the
            card (TF32 off) and on the CPU from the same weights and batch
            (F=36, 96², batch 2, ground-truth maps with 1e-3 noise; see
            `mag_step_parity`): loss, metrics and every gradient leaf
            compared, with a float64 witness, and the same steps at the
            zero-bias TEEncoder init reported beside them. Then `ideal_gan_tpu_torch.cli.infer.main --model_sel
            Mag` on 16 slices at batch 8 with the counters read around it
            (fails unless the magnitude fit and ConvLSTM forward kernels
            ran once a chunk), and its first slices on the card (TF32 off)
            and on the CPU, maps compared.
8. vetnet_serve
            `ideal_gan_tpu_torch.cli.train_teaug.main` for one epoch (F=72,
            16 synthetic 384² slices, batch 8: 2 steps), then
            `ideal_gan_tpu_torch.cli.infer.main --model_sel VET-Net
            --experiment_dir` on that run at batch 8, with every launch
            counter set to 0 just before and read just after the serving
            call; fails unless the ConvLSTM forward ran once an echo of
            every chunk (18 launches), the checkpoint restored is the one
            of step 2, and its maps differ from those of the seeded initial
            weights. Then the first 2 slices on the card (TF32 off), on the
            CPU, on the card with the plain ConvLSTM, and on the CPU with
            the net in float64 (see `vetnet_serve_phase`): the net's (φ,
            R2*) held to the CPU's, and the phase-constrained fit on the
            card's (φ, R2*) held to the CPU's fit of them.
9. sup      `ideal_gan_tpu_torch.cli.train_sup.main` for one epoch (F=72,
            16 synthetic 384² slices, batch 8: 2 steps) at the JAX
            `DEFAULTS` (multi-decod, out_vars WF), then with `--G_model
            U-Net --out_vars PM --TE1 0.0014 --dTE 0.0022` (resynthesis),
            and `cli.infer.main --model_sel 2D-Net --experiment_dir` on the
            second run, each with every launch counter set to 0 just before
            and read just after; fails unless the second run launched the
            synthesis and fit kernels once a step, the serving run the fit
            once a chunk (3 with the warm-up), every loss is finite, the
            checkpoint restored is the run's last and its maps differ from
            the seeded initial weights'. Then one step of multi-decod WF,
            U-Net PM with resynthesis and multi-decod WF-PM (MDWF-Net) on
            the card (TF32 off) and on the CPU (96², batch 2, 1e-3 noise,
            float64 witness; see `sup_step_parity`), and the 2D-Net's first
            2 slices on the card and on the CPU: its (R2*, FM) compared, and
            the map fit of the card's (R2*, FM) on the CPU held to the card's.
10. teaug_gens
            `ideal_gan_tpu_torch.cli.train_teaug.main --G_model` U-Net,
            2U-Net and MDWF-Net, each for one epoch (F=72, 16 synthetic 384²
            slices, batch 8: 2 steps) with the counters read around it;
            fails unless the synthesis kernel ran once a step (twice for the
            2U-Net: its R2* step too), the ConvLSTM forward and backward and
            the fit at least once a step (U-Net, 2U-Net), every loss is
            finite and every ConvLSTM and TE parameter of the trained nets
            has a non-zero gradient. Then one step of each on the card (TF32
            off) and on the CPU (96², batch 2, float64 witness; both 2U-Net
            steps; see `teaug_gens_parity`), and one G_A2R2 step on the card,
            which must change G_A2R2 and leave G_A2B as it was.
11. uq       `ideal_gan_tpu_torch.cli.train_unsup.main --out_vars PM --UQ 1
            --UQ_R2s 1 --UQ_calib 1` for one epoch (F=36, 24 synthetic 384²
            slices at batch 8: a calibration split of 8, 2 step pairs, then
            the calibration stage with its held-out NLL); one more step
            pair and one calibration step, each counted alone and timed;
            `cli.infer.main --model_sel AI-DEAL --experiment_dir` on that
            run with `--map PDFF-var` and with `--map PDFF`, each with the
            counters read around it; fails unless the cycle and both
            ConvLSTM kernels ran on the training path, the cycle and the
            ConvLSTM forward (and not the backward) on the calibration step,
            the fit once a chunk under `--map PDFF`, the calibrated
            checkpoint was served and every ConvLSTM parameter has a
            gradient. Then the UQ FM step, the R2 step and the calibration
            step on the card (TF32 off) and on the CPU (96², batch 2, 1e-3
            noise, float64 witness; see `uq_step_parity`), and PDFF-var
            serving per stage on 2 slices: the heads' mean and variance card
            vs CPU, and `pdff_uncertainty` on the card's heads on both.
12. single   `ideal_gan_tpu_torch.cli.train_single.main` at the JAX
            `DEFAULTS` (F=36, bipolar, 3 slices at 384²) for 4 full-batch
            steps with the counters read around it, then one step counted
            alone and three timed; fails unless both ConvLSTM kernels ran
            every step, every loss is finite and every ConvLSTM parameter of
            both nets has a gradient. Then one step on the card (TF32 off)
            and on the CPU (96², 3 slices, 1e-3 noise, float64 witness; see
            `single_step_parity`).
13. options  the trainers' bf16, remat and microbatch options at full
            width (see `options_phase`): `cli.train_unsup --out_vars PM
            --bf16 1 --remat 1` (F=36, 16 slices, batch 8, 2 epochs), its
            launches against `UNSUP_REMAT_PAIR`, its peak memory beside the
            train phase's f32 run, and one bf16 FM and R2 step card vs CPU
            (96², batch 2) within `bf16_step_gate`, whose three controls
            (the f32 step, a zeroed and a flipped gradient) must fail it;
            `cli.train_teaug --bf16 1 --remat 1` (VET-Net, F=72, one epoch)
            and three steady steps with their peak memory; `cli.train_teaug
            --microbatch 2` (F=72, f32, one epoch), then the microbatched
            gradients held to the full batch's on the same noise (loss
            2e-5, gradients 2e-2 of scale) and both steps timed.
14. record  the run record at full width: `cli.train_sup --G_model U-Net
            --out_vars PM` (F=72, 44 synthetic 384² slices, batch 2: 4 held
            out, 20 steps an epoch) for 2 epochs, counted; fails unless
            settings.yml reads back equal to the flags over `sup.DEFAULTS`,
            every metric of each epoch's last step equals its `G_losses/*`
            scalar (float32) in the train and validation event files at
            steps 20 and 40, the last epoch's checkpoint is there, and a
            rerun to 3 epochs under `--profile_dir` resumes from epoch 2,
            runs only the third (summary at 60) and writes a
            `torch.profiler` trace with device kernels; the fit kernel once
            a step. Then `train.common.TrainLoop` with the AI-DEAL FM step
            (F=36, batch 2, 10 steps an epoch, a checkpoint every epoch):
            2 epochs (the cycle and both ConvLSTM kernels every step, a
            summary at step 20), then 3, which must skip the 2 finished.
            Reports the step's ms with and without `RunRecord.step` in
            turns (`record_cost`).
15. preempt `cli.train_sup` (U-Net PM, F=72, 4 slices at batch 2, 500
            epochs) in a subprocess, SIGTERM after its "epoch 2/" line;
            fails unless it exits 0 with "preempted: checkpointed epoch N",
            ckpt-N is on disk, and a rerun to N + 1 epochs prints "resumed
            from epoch N" and exits 0.
16. roi      `cli.roi_analysis.main --model_sel AI-DEAL` (F=36, 16
            synthetic 384² slices, `--infer_batch 8`, TF32 on) served from
            the train phase's run, two ROIs a slice from `save_crops`,
            counted; fails unless its workbook, read back by `read_xlsx`,
            equals `roi_stats` of the maps `infer_maps` returned, the fit
            and ConvLSTM forward ran once a chunk, and, as e2e compares,
            the first chunk served again with TF32 off has its ROI PDFF
            within 5e-3 of the CPU's where the ROI's median |W+F| > 0.2
            (the counted run's gap to the CPU is reported).
17. phantom  the port's 11-vial phantom (`cli.phantom_parity`, 192×128)
            at 1.5 T and 3 T, TF32 on, each counted: the synthesis, fit
            and magnitude fit kernels once each, every vial median of both
            paths within 5e-4 PDFF of `PHANTOM_PARITY.json`'s `repo` value,
            the complex path within 0.03 of the ground truth, and the
            medians with TF32 off equal to these; then
            `cli.roi_realphantom`'s GraphCuts path on the 1.5 T phantom
            with the 11 vial ROIs, whose workbook must hold 11 vials. The
            44 medians are printed.
18. gan      `ideal_gan_tpu_torch.cli.train_gan.main --adv_train 1` at the
            JAX `DEFAULTS` (F=36, 4 levels, 2 residual blocks, latent 258,
            PatchGAN 72 with self-attention, the VGG perceptual cycle;
            batch 1, 16 synthetic 192² slices, 2 epochs: 32 g-steps and
            32 d-steps), counted, then one g-step and one d-step counted
            alone, timed (ms, peak memory, device ms: all kernels, the
            ConvLSTM kernels, the VGG perceptual part and the R1 double
            backward each alone, idle shares); one short epoch (4 slices)
            each with `--VQ_encoder 1`, `--cGAN 1` and `--bf16 1`, counted
            the same way. Fails unless the ConvLSTM kernels of the run's
            dtype ran on every g-step (the run's launches equal the g-steps
            times one g-step's) and never on a d-step, every loss and
            metric is finite, every encoder ConvLSTM parameter has a
            gradient and the discriminator's spectral-norm u changed on
            d-steps only. Then the g-step with and without the adversary
            and the d-step (R1 included) on the card (TF32 off) and on the
            CPU at 96² with a float64 witness (`gan_step_parity`; loss and
            metrics 2e-5 of max(|CPU|, 1), the VGG perceptual loss 1e-4,
            gradients 2e-2 of scale, or within the float64 envelope,
            `_gan_parity_failures`), and the bf16 g-step without the
            adversary card vs CPU within `gan_bf16_gate`
            (`bf16_step_gate` with its loss rule in bf16 ulps), whose three
            controls must fail it.

19. ldm      the LDM family on the gan phase's runs (kept on disk until
            then): `cli.train_ldm.main` at the LDM `DEFAULTS` (T=200, F=64,
            dim_mults (1, 2, 4), batch 8; the latent (12, 12, 258) of the
            GAN at its DEFAULTS) on 16 synthetic 192² slices for 2 epochs,
            counted and timed (ms per step and per denoiser call, device
            ms, idle shares, peak memory, the encode's ConvLSTM forward);
            `cli.gen_ldm_dataset.main --write_dicom 1` (16 samples in
            batches of 8, the 200-step DDPM chain), its shards read back
            and every volume's PDFF, R2s and MultiEcho DICOM pixels equal
            to uint16(255·clip(·, 0, 1)) of them; `cli.test_genmetrics
            .main --use_ldm 1` (DDIM, 50 steps); one epoch of `train_ldm` on
            the bf16 GAN run. Fails unless the encoder's ConvLSTM forward
            kernel of the GAN run's dtype launched 6 times an encode (the
            z_std pass, the `in_res` probe, every step) and the backward
            never, z_std is within 1e-6 of its float64 recomputation over
            the same latents and in `checkpoints_ldm/`, every loss and
            metric is finite, every denoiser parameter has a non-zero
            gradient (but the class planes' Dense kernels without classes,
            exactly zero), the shards are (16, 6, 192, 192, 2) and (16, 3,
            192, 192, 2) and finite, and FID, MMD, SSIM and MS-SSIM are
            finite. Then, at full width with batch 2 and TF32 off
            (`ldm_step_parity`): the denoiser step card vs CPU with a
            float64 witness (`_gan_parity_failures`' rule), one DDPM and
            one DDIM reverse step within 1e-5 of scale, and a 50-step DDIM
            chain on identical noise no farther from the float64 chain than
            2× the CPU's.
20. parallel the multi-device paths at full width (AI-DEAL, 384², 6
            echoes, global batch 8, F=36; see `parallel_phase`), on every
            card, or on the one card twice: (a) `parallel.make_sharded_fit`,
            the slice split (nb=8) and the H split (nb=2) bit-equal to the
            unsplit `fit_rho_planar`, one fit launch per shard, the
            indivisible case raising; (b) two ranks spawned (NCCL with a
            card each where there are two cards or more, else gloo with
            both on one card, named on the line) for 2 AI-DEAL step pairs
            on 4 rows each, TF32 off: parameters bit-identical after each
            pair, the first step's loss within 2e-5 and its gradients
            within 2e-2 of scale of the one-process batch-8 step on the
            card (float64 witness: the plain ConvLSTM in float64 there),
            per rank per pair the train phase's launches at batch 4
            (`DP_PAIR_LAUNCHES`), ms per pair, the all-reduce's host and
            device ms, peak memory; (c) `cli.train_unsup` through
            `torch.distributed.run --standalone --nproc_per_node
            <device_count>` (16 slices, one epoch, then a resume to two):
            exit 0, one settings.yml, one checkpoint directory, one event
            file; (d) an AI-DEAL chunk of 8 through `_per_slice` split over
            the cards (one net replica each), TF32 off: maps within 5e-3 of
            the unsplit chunk, and the fit on identical net outputs split
            and whole bit for bit.
21. rest     the last modules, TF32 off, card vs CPU on the same weights,
            inputs and replayed noise (`prob.Replay`), each within
            REST_TOL (1e-4) of its CPU scale or inside the float64
            envelope (a float64 run on the CPU; InceptionV3 held to
            REST_TOL alone; `rest_modules`; the large modules' CPU runs
            overlap their card work; times by CUDA events after a
            warm-up, TF32 off and on):
            BayesDecoder and Decoder(bayes_layer) at the GAN's DEFAULTS
            (latent (1, 12, 12, 258), F=36, 4 levels), train and eval,
            with their KL sums; CriticZ (64, 3 levels) on that latent;
            SGAN (32, 5 layers) in train mode on 8 × 6 folded 384² echoes
            with its running statistics; PMComplex (F=72, 4 levels, 384²,
            batch 2) train then eval with its statistics, its CPU and
            float64 runs taking the card's complex max-pool routes, the
            windows whose route the CPU would flip counted
            (`_PoolRoutes`); the InceptionV3
            features of 8 × 6 echoes through `echoes_to_inception_input`
            at 139². `losses.gradient_penalty` wgan-gp and dragan through
            the GAN's PatchGAN (72, 192², one slice's 6 echoes): the
            penalty and the critic's double-backward gradient card vs CPU
            (`_parity`, its witness lazy: loss 2e-5, gradients 2e-2 of
            scale, or the CPU float64 envelope). `cli.test_gradients.main` at its DEFAULTS
            (F=8, 2 synthetic 384² slices every 8th pixel) and at F=36,
            384², counted: exactly `TEST_GRADIENTS_LAUNCHES` a run,
            gradients finite and non-zero, each configuration's loss and
            R2* gradient card vs CPU (`_parity`). `--debug_nans 1`:
            the same loss as without it; a NaN in the R2* head's weight
            raises `FloatingPointError` naming the convolution, and one in
            the ConvLSTM forward's and backward's inputs names the kernel.

The kernels phase holds the ConvLSTM kernels at the GAN encoder's shape
too ((Cin=2, F=36, nb=1, 192²), f32 and bf16), the forward also at the
LDM's encode ((Cin=2, F=36, nb=8, 192²), f32 and bf16), and checks them
batch-elementwise there (`convlstm_batch_elementwise`: h and dx at nb=2
equal to two nb=1 launches bit for bit; dk, db to their sum), and the four
per-voxel kernels batch-elementwise at (nb=2, 384², ne=6) in each phasor
form, the fit also through `fit_rho_planar` in f32 and bf16 echoes
(`per_voxel_batch_elementwise`: bit for bit).

The kernels phase also holds the ConvLSTM kernels' bf16 storage mode
(`convlstm_bf16_entries`): the forward and the backward (kink-free inputs)
at Cin 2 and 1, F=36 and F=72, nb=8, 384², against their bf16 plain
versions at `bf16_gate` and `BF16_ULP_SHARE`, two launches bit for bit,
with the f32 kernel and the float64 plain version as witnesses (the f32
kernel's output, a control, must fail those gates), times and bounds, and
their SASS (`BF16_SASS`): each kernel must hold the bf16 tensor-core
instruction and the staging it is built on (`BF16_CLAIMS`: HGMMA and TMA
for the wgmma mainloop, HMMA and cp.async for the sweep's other stages).

Each phase line carries its seconds. The last three lines are the card's
`nvidia-smi` name and power limit, the `{"kernels": [...]}` summary (launches from the path that runs each kernel:
the train phase for the cycle and the ConvLSTM backward, teaug for the
synthesis, e2e for the fit and the ConvLSTM forward, mag's training run for
the magnitude fit, the options phase's bf16 AI-DEAL run for the bf16
ConvLSTM kernels; vetnet_serve prints its own; `launches_on_new_paths` the
counts of the sup, teaug_gens, uq, single and options runs, and of
roi_aideal, phantom_1p5T, phantom_3T, record (TrainLoop's first run),
record_cli, gan, gan_vq, gan_cgan, gan_bf16, ldm, ldm_gen,
ldm_metrics, ldm_bf16, io_train_dicom, io_train_nifti, io_infer, the
parallel phase's per-rank and per-split launches, and the rest phase's
two cli.test_gradients runs) and
`{"ok": true,
"device": {...}}`.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): FP32 on CUDA cores, HBM3 bandwidth,
# and FP32 products as 3xTF32 on the tensor cores (three TF32 MMAs each)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_3XTF32_FLOPS = 495e12 / 3
# dense bf16 on the tensor cores (H100 SXM data sheet), and bf16's unit
# roundoff
PEAK_BF16_FLOPS = 989e12
BF16_U = 2.0 ** -8

SIZE, NE, F_MAIN, NB_SERVE = 384, 6, 36, 8
F_TEAUG = 72  # VET-Net's width (teaug DEFAULTS)
GAN_SIZE = 192  # the GAN trainer's data_size (gan DEFAULTS, batch 1)
# g-gate bias of the ConvLSTM backward's inputs kept clear of leaky_relu's
# kink: every g-gate pre-activation and cell positive, or every one negative
KINK_FREE = {"smooth": 1.5, "negative": -1.5}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, dev, iters: int = 10, warmup: int = 2) -> float:
    """Mean time of one call: CUDA events around `iters` calls after
    warm-up (a host clock on the CPU, for rehearsals only)."""
    import torch
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def device_ms(fn, dev, fragment: str, iters: int = 20):
    """Mean device time per call of `fn` of the kernels whose name holds
    `fragment`, from torch.profiler (None on the CPU). `time_ms` over
    back-to-back launches of a ~0.05 ms kernel measures the host's launch
    rate; this reads the kernel's own duration."""
    split = device_ms_by(fn, dev, {fragment: fragment}, iters)
    return split and split[fragment]


def device_ms_by(fn, dev, fragments: dict, iters: int = 3):
    """Mean device time per call of `fn` of the kernels whose name holds
    each fragment of `fragments` ({label: fragment}), from one
    torch.profiler window (None on the CPU)."""
    import torch
    from torch.autograd import DeviceType
    if dev.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize(dev)
    events = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    return {label: sum(ev.time_range.elapsed_us() for ev in events
                       if frag in ev.name) / 1e3 / iters
            for label, frag in fragments.items()}


def sass_counts(name: str, fragments, opcodes: dict) -> dict | None:
    """Per kernel of the built `csrc/<name>.cu` whose symbol holds one of
    `fragments`: for each label of `opcodes` ({label: (substring, ...)}),
    the number of `cuobjdump -sass` instruction lines that hold every one of
    its substrings (None where there is no build or no cuobjdump)."""
    import shutil
    from ideal_gan_tpu_torch.ops import _build
    lib = _build._lib_path(name)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not lib.exists() or not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts = {f: dict.fromkeys(opcodes, 0) for f in fragments}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((f for f in fragments if f in line), None)
        elif current:
            for label, subs in opcodes.items():
                if all(sub in line for sub in subs):
                    counts[current][label] += 1
    return counts


def hmma_counts(name: str, fragments, opcode: str = "") -> dict | None:
    """The number of tensor-core instructions (HMMA, or Hopper's warpgroup
    HGMMA) `cuobjdump -sass` finds in each kernel of the built
    `csrc/<name>.cu` whose symbol holds one of `fragments` (None where there
    is no build or no cuobjdump); with `opcode`, only those whose line holds
    it (e.g. "BF16")."""
    got = sass_counts(name, fragments, {"HMMA": ("HMMA", opcode),
                                        "HGMMA": ("HGMMA", opcode)})
    return None if got is None else {k: v["HMMA"] + v["HGMMA"]
                                     for k, v in got.items()}


def bound(n_bytes: float, flops: float,
          peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def set_tf32(on: bool) -> None:
    import torch
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def build_phase() -> None:
    from ideal_gan_tpu_torch.ops import _build
    t0 = time.perf_counter()
    reports = _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in rep.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, rep in reports.items()}
    emit("build", seconds=round(secs, 3), ptxas=ptxas)


def bench_inputs(nb: int, size: int, dev):
    """bench.py's synthetic fit inputs: real water/fat, field map and R2*
    drawn uniformly, echoes from the forward model. Returns (acqs MEBCRN,
    maps, te) on `dev`."""
    import numpy as np
    import torch
    from ideal_gan_tpu_torch import physics
    rng = np.random.default_rng(0)
    shape = (nb, size, size)
    water = rng.uniform(0.1, 0.7, shape).astype(np.float32)
    fat = rng.uniform(0.0, 0.5, shape).astype(np.float32)
    phi = rng.uniform(-0.3, 0.3, shape).astype(np.float32)
    r2s = rng.uniform(0.0, 0.5, shape).astype(np.float32)
    zeros = np.zeros_like(water)
    maps = torch.from_numpy(np.stack([
        np.stack([water, zeros], -1), np.stack([fat, zeros], -1),
        np.stack([phi, r2s], -1)], axis=1)).to(dev)
    te = physics.te_train(NE, bs=nb, device=dev)
    return physics.synthesize(maps, te), maps, te


def fit_entry(dev, size: int = SIZE, nbs=(NB_SERVE, 128)) -> dict:
    """The fit kernel against `physics.fit_rho` on the same inputs."""
    import torch
    from ideal_gan_tpu_torch import ops, physics

    def pdff(rre, rim):
        w = torch.complex(rre[:, 0].float(), rim[:, 0].float()).abs()
        f = torch.complex(rre[:, 1].float(), rim[:, 1].float()).abs()
        return f / torch.clamp(w + f, min=1e-6)

    cases = []
    for nb in nbs:
        acqs, maps, te = bench_inputs(nb, size, dev)
        pm = maps[:, 2:3].contiguous()
        nv = nb * size * size
        plain = lambda: physics.fit_rho(acqs, pm, te)  # noqa: E731
        ref = plain()
        plain_ms = time_ms(plain, dev)
        gt_err = None
        if nb == nbs[0]:
            # the serving call: MEBCRN in place, as cli.infer runs it (with
            # its per-call M⁺ build); the kernel alone timed on the same
            # interleaved views with M⁺ precomputed
            fused = lambda: ops.fit_rho_fused(acqs, pm, te)  # noqa: E731
            out = fused()
            pre = ops.precompute_fit_matrices(te)
            kernel_only = lambda: ops.fit_rho_planar(  # noqa: E731
                acqs[..., 0], acqs[..., 1], pm[:, 0, ..., 0],
                pm[:, 0, ..., 1], te, precomputed=pre)
            err = float((out - ref).abs().max())
            tol_ok = bool(((out - ref).abs()
                           <= 1e-5 + 1e-4 * ref.abs()).all())
            gt_err = float((out - maps[:, :2]).abs().max())
            n_bytes = nv * (NE * 8 + 8 + 2 * 8)
            b_ms, b_by = bound(n_bytes, nv * (NE * 24 + 5 * 6))
            cases.append(dict(
                call="fit_rho_fused MEBCRN", nb=nb, echoes="f32",
                rho="f32", max_abs_err=err, within_tol=tol_ok,
                gt_max_err=gt_err, ms=time_ms(kernel_only, dev),
                device_ms=device_ms(kernel_only, dev, "fit_kernel"),
                call_ms=time_ms(fused, dev), plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by))
            cases.append(_fit_teaug_case(maps, pm, nb, dev, b_ms, b_by))
        s_re = acqs[..., 0].contiguous()
        s_im = acqs[..., 1].contiguous()
        phi = maps[:, 2, ..., 0].contiguous()
        r2s = maps[:, 2, ..., 1].contiguous()
        pre = ops.precompute_fit_matrices(te)
        f32_out = None
        for echoes, rho_t in (("f32", torch.float32),
                              ("bf16", torch.float32),
                              ("bf16", torch.bfloat16)):
            e_t = torch.float32 if echoes == "f32" else torch.bfloat16
            a_re, a_im = s_re.to(e_t), s_im.to(e_t)
            fit = lambda: ops.fit_rho_planar(  # noqa: E731
                a_re, a_im, phi, r2s, te, uniform_te=True,
                precomputed=pre, out_dtype=rho_t)
            rre, rim = fit()
            # plain version on the same (rounded) echoes
            ref_c = physics.fit_rho(
                torch.stack([a_re.float(), a_im.float()], -1), pm, te)
            got = torch.stack([rre.float(), rim.float()], -1)
            err = float((got - ref_c).abs().max())
            if rho_t == torch.float32:
                tol_ok = bool(((got - ref_c).abs()
                               <= 1e-5 + 1e-4 * ref_c.abs()).all())
            else:
                # bf16 stores keep 8 bits of mantissa: |rho| < 1.5 rounds
                # by at most 2^-8
                tol_ok = err <= 2 ** -8 * 1.5
            if f32_out is None:
                f32_out = (rre, rim)
                gt = float((got - maps[:, :2]).abs().max())
                if gt >= 5e-2:
                    raise AssertionError(f"fit inaccurate vs ground truth: "
                                         f"max err {gt}")
            pdff_dev = float((pdff(rre, rim) - pdff(*f32_out)).abs().max())
            if pdff_dev >= 3e-3:
                raise AssertionError(f"fit {echoes}/{rho_t}: PDFF deviates "
                                     f"{pdff_dev} from f32 (gate 3e-3)")
            in_b = 2 if e_t == torch.bfloat16 else 4
            out_b = 2 if rho_t == torch.bfloat16 else 4
            n_bytes = nv * (NE * 2 * in_b + 8 + 2 * 2 * out_b)
            b_ms, b_by = bound(n_bytes, nv * (NE * 24 + 5 * 6))
            cases.append(dict(
                call="fit_rho_planar", nb=nb, echoes=echoes,
                rho="bf16" if rho_t == torch.bfloat16 else "f32",
                max_abs_err=err, within_tol=tol_ok, pdff_dev_vs_f32=pdff_dev,
                ms=time_ms(fit, dev), plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by))
        del acqs, maps, s_re, s_im
    bad = [c for c in cases if not c["within_tol"]]
    if bad:
        raise AssertionError(f"fit kernel disagrees with fit_rho: {bad}")
    main = cases[0]
    return dict(
        name=ops.FIT_KERNEL.name, route="cuda", source=ops.FIT_KERNEL.source,
        replaces="ideal_gan_tpu/ops/pallas_ideal.py:141",
        launches=None, max_abs_err=main["max_abs_err"], ms=main["ms"],
        device_ms=main["device_ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None,
        tolerance="|d| <= 1e-5 + 1e-4*|plain| (f32 rho), 2^-8*1.5 (bf16 "
                  "rho)", cases=cases)


def _fit_teaug_case(maps, pm, nb: int, dev, bound_ms: float,
                    bound_by: str) -> dict:
    """The fit at the TE-augmentation trainer's WF_loss call: echoes
    synthesized from `maps` at a jittered TE train from
    `sample_te_train` plus the trainer's 0.1·N(0, 1) noise, fitted with the
    per-echo phasors (uniform_te=False), MEBCRN in place."""
    import torch
    from ideal_gan_tpu_torch import ops, physics
    gen = torch.Generator().manual_seed(5)
    te = physics.sample_te_train(gen, NE, nb, device=dev)
    clean = physics.synthesize(maps, te)
    noise = torch.randn(clean.shape, generator=gen).to(dev)
    acqs = clean + 0.1 * noise
    plain = lambda: physics.fit_rho(acqs, pm, te)  # noqa: E731
    fused = lambda: ops.fit_rho_fused(  # noqa: E731
        acqs, pm, te, uniform_te=False)
    pre = ops.precompute_fit_matrices(te)
    kernel_only = lambda: ops.fit_rho_planar(  # noqa: E731
        acqs[..., 0], acqs[..., 1], pm[:, 0, ..., 0], pm[:, 0, ..., 1], te,
        uniform_te=False, precomputed=pre)
    ref, out = plain(), fused()
    return dict(
        call="fit_rho_fused MEBCRN, jittered TE, per-echo (teaug WF_loss)",
        nb=nb, echoes="f32", rho="f32", uniform_te=False,
        max_abs_err=float((out - ref).abs().max()),
        within_tol=bool(((out - ref).abs() <= 1e-5 + 1e-4 * ref.abs()).all()),
        ms=time_ms(kernel_only, dev),
        device_ms=device_ms(kernel_only, dev, "fit_kernel"),
        call_ms=time_ms(fused, dev), plain_ms=time_ms(plain, dev),
        bound_ms=bound_ms, bound_by=bound_by)


# Cin=1, F=72: the 2U-Net's R2* net on the echo magnitudes (after Cin=2, so
# that the wide case stays VET-Net's); Cin=1, nb=3: the single-subject
# trainer's G_mag and G_pha on its 3 slices; (Cin=2, F=36, nb=1, 192²): the
# GAN trainer's encoder front (a 4th entry is the size, else SIZE)
LSTM_SHAPES = ((2, F_MAIN, NB_SERVE), (1, F_MAIN, NB_SERVE),
               (2, F_TEAUG, NB_SERVE), (1, F_TEAUG, NB_SERVE),
               (1, F_MAIN, 3), (2, F_MAIN, 1, GAN_SIZE))
# the forward also at nb=6, the UQ calibration stage's batch (its 8-slice
# split less the 2 held out), for the FM (Cin=2) and R2* (Cin=1) nets, and
# at (Cin=2, F=36, nb=8, 192²), the frozen GAN encoder on an LDM batch
LDM_ENCODE_SHAPE = (2, F_MAIN, NB_SERVE, GAN_SIZE)
LSTM_FWD_SHAPES = LSTM_SHAPES + ((2, F_MAIN, 6), (1, F_MAIN, 6),
                                 LDM_ENCODE_SHAPE)
# the ConvLSTM forward kernel's symbol holds this (it is also the
# backward's state recompute)
LSTM_FWD = "convlstm_echo"


# the ConvLSTM checks' numpy draws by (Cin, F, nb, size, seed): `_lstm_inputs`
_LSTM_INPUTS: dict = {}


def _lstm_inputs(dev, cin, f, nb, size, seed, with_g=True):
    """The ConvLSTM kernel checks' inputs on `dev` (float32 copies): x
    (nb, ne, H, W, Cin)·0.5, k (3, 3, Cin+F, 4F) He-scaled, b (4F,)·0.1
    and, `with_g`, g (nb, H, W, F), drawn in that order from
    `default_rng(seed)`. The numpy draws are kept in `_LSTM_INPUTS`
    (cleared after the kernels phase), so that the checks sharing a seed
    and shape draw them once (g the first time one asks for it)."""
    import numpy as np
    import torch
    key = (cin, f, nb, size, seed)
    drawn = _LSTM_INPUTS.get(key)
    if drawn is None:
        rng = np.random.default_rng(seed)
        drawn = _LSTM_INPUTS[key] = [
            (rng.normal(size=(nb, NE, size, size, cin)) * 0.5
             ).astype(np.float32),
            (rng.normal(size=(3, 3, cin + f, 4 * f))
             * (2.0 / (9 * (cin + f))) ** 0.5).astype(np.float32),
            (rng.normal(size=(4 * f,)) * 0.1).astype(np.float32), rng, None]
    if with_g and drawn[4] is None:
        drawn[4] = drawn[3].normal(size=(nb, size, size, f)).astype(
            np.float32)
    arrays = drawn[:3] + ([drawn[4]] if with_g else [])
    return tuple(torch.from_numpy(a).to(dev, copy=True) for a in arrays)


def convlstm_entry(dev, size: int = SIZE, shapes=LSTM_FWD_SHAPES) -> dict:
    """The ConvLSTM forward kernel against `convlstm_reference` at each
    (Cin, F, nb) of `shapes`: held to the plain version in float32 (TF32
    off) and in float64, each to 1e-4 of scale; a second launch bit for bit
    (`deterministic`); the call's CUDA-event time and the kernel's device
    time (torch.profiler) beside its 3xTF32 bound (`bound_ms`) and its FP32
    one (`bound_fp32_ms`); one echo's gate convolution in cuDNN with TF32
    off and on as a partial yardstick; and the HMMA instructions `cuobjdump
    -sass` finds in the kernel (the run fails if there are none)."""
    import torch
    import torch.nn.functional as F
    from ideal_gan_tpu_torch import ops
    cases, default_size = [], size
    for cin, f, nb, *sz in shapes:
        size = sz[0] if sz else default_size
        x, k, b = _lstm_inputs(dev, cin, f, nb, size, cin, with_g=False)
        call = lambda: ops.convlstm_forward(x, k, b)  # noqa: E731
        out = call()
        deterministic = torch.equal(out, call())
        ref = ops.convlstm_reference(x, k, b)
        ref64 = ops.convlstm_reference(x.double(), k.double(), b.double())
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        err64 = float((out.double() - ref64).abs().max())
        plain64 = float((ref.double() - ref64).abs().max())
        scale64 = float(ref64.abs().max())
        del out, ref, ref64
        kernel_ms = time_ms(call, dev, iters=5)
        dev_ms = device_ms(call, dev, LSTM_FWD, iters=3)
        plain_ms = time_ms(lambda: ops.convlstm_reference(x, k, b), dev,
                           iters=5)
        # partial yardstick: one echo's gate convolution alone (cuDNN),
        # FP32 and TF32
        inp = torch.zeros((nb, cin + f, size, size), device=dev)
        w = k.permute(3, 2, 0, 1).contiguous()
        conv = lambda: F.conv2d(inp, w, padding=1)  # noqa: E731
        conv_ms = time_ms(conv, dev, iters=5)
        set_tf32(True)
        conv_tf32_ms = time_ms(conv, dev, iters=5)
        set_tf32(False)
        npx = nb * size * size
        flops = 2 * 9 * 4 * f * npx * (cin + (NE - 1) * (cin + f))
        n_bytes = 4 * (x.numel() + k.numel() + b.numel() + npx * f)
        b_ms, b_by = bound(n_bytes, flops, PEAK_3XTF32_FLOPS)
        cases.append(dict(cin=cin, F=f, ne=NE, nb=nb, size=size,
                          max_abs_err=err,
                          ref_max_abs=scale, max_abs_err_vs_f64=err64,
                          plain_f32_vs_f64=plain64, f64_max_abs=scale64,
                          deterministic=deterministic, ms=kernel_ms,
                          device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by,
                          bound_fp32_ms=bound(n_bytes, flops)[0],
                          gflop=flops / 1e9,
                          cudnn_one_echo_gate_conv_ms_partial=conv_ms,
                          cudnn_one_echo_gate_conv_tf32_ms_partial=(
                              conv_tf32_ms)))
        # f32 sums over K = 9*(Cin+F) = 342 terms in another order than
        # cuDNN's, carried through 6 echoes of the recurrence; the float64
        # plain version as the backward's kink-free cases are held
        if err > 1e-4 * max(scale, 1.0) or err64 > 1e-4 * scale64 \
                or not deterministic:
            raise AssertionError(f"convlstm kernel disagrees with the "
                                 f"reference: {cases[-1]}")
        del x, inp
        torch.cuda.empty_cache()
    # the 3xTF32 kernel's own (the bf16 mode's symbol holds LSTM_FWD too)
    hmma = hmma_counts(ops.CONVLSTM_KERNEL.name, [LSTM_FWD], "TF32")
    if hmma is not None and not all(hmma.values()):
        raise AssertionError(f"the ConvLSTM forward has no tensor-core "
                             f"instruction: {hmma}")
    main = cases[0]
    return dict(
        name=ops.CONVLSTM_KERNEL.name, route="cuda",
        source=ops.CONVLSTM_KERNEL.source,
        replaces="ideal_gan_tpu/ops/pallas_convlstm.py:177",
        launches=None, max_abs_err=max(c["max_abs_err"] for c in cases),
        max_abs_err_vs_f64=max(c["max_abs_err_vs_f64"] for c in cases),
        ms=main["ms"], device_ms=main["device_ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], bound_fp32_ms=main["bound_fp32_ms"],
        hmma=hmma, deterministic=all(c["deterministic"] for c in cases),
        library_ms=None,
        tolerance="|d| <= 1e-4 * max(|plain f32|max, 1) and |d vs plain "
                  "f64| <= 1e-4 * |plain f64|max; two launches "
                  "bit-identical; bound_ms: 3xTF32 on the tensor cores "
                  "(bound_fp32_ms: FP32 on the CUDA cores)",
        cases=cases, wide=_widest(cases))


def _widest(cases) -> dict:
    """The timed case of the largest F (VET-Net's width)."""
    c = max((c for c in cases if "ms" in c), key=lambda c: c["F"])
    return {k: c[k] for k in ("cin", "F", "nb", "ms", "plain_ms", "bound_ms",
                              "bound_by", "device_ms", "bound_fp32_ms",
                              "recompute", "sweep", "stages_device_ms")
            if k in c}


def cycle_entry(dev, size: int = SIZE, nb: int = NB_SERVE) -> dict:
    """The cycle kernel against `physics.cycle_full` on the same inputs."""
    from ideal_gan_tpu_torch import ops, physics
    from ideal_gan_tpu_torch.ops import ideal
    from ideal_gan_tpu_torch.physics import constants as pc
    acqs, maps, te = bench_inputs(nb, size, dev)
    pm = (maps[:, 2:3] + 0.02).contiguous()  # off the truth: Â ≠ A
    plain = lambda: physics.cycle_full(acqs, pm, te)  # noqa: E731
    ref_rho, ref_recon = plain()
    plain_ms = time_ms(plain, dev)
    nv = nb * size * size
    # read echoes 8·ne + (φ, R2*) 8, write ρ 16 + Â 8·ne bytes a voxel
    n_bytes = nv * (NE * 8 + 8 + 16 + NE * 8)
    b_ms, b_by = bound(n_bytes, nv * NE * 48)
    pre = ops.precompute_cycle_matrices(te)
    cases = []
    for flag, rel, ab in ((None, 1e-4, 1e-5), (True, 2e-4, 2e-5)):
        # the trainer's call (with its per-call M, M⁺ build), and the
        # kernel alone with M, M⁺ precomputed (the call itself on the CPU,
        # where there is no kernel)
        call = lambda: ops.cycle_full_fused(  # noqa: E731
            acqs, pm, te, uniform_te=flag)
        kernel_only = call if dev.type == "cpu" else (
            lambda: ideal._cycle_kernel(
                acqs, pm, te, 1.5, pc.R2_SC, pc.FM_SC, pc.RHO_SC,
                pc.WATER_FAT_7PEAK, flag, pre))
        rho, recon = kernel_only()
        errs = [float((a - r).abs().max())
                for a, r in ((rho, ref_rho), (recon, ref_recon))]
        ok = all(bool(((a - r).abs() <= ab + rel * r.abs()).all())
                 for a, r in ((rho, ref_rho), (recon, ref_recon)))
        cases.append(dict(uniform_te=flag, nb=nb, ne=NE, size=size,
                          rho_max_abs_err=errs[0],
                          recon_max_abs_err=errs[1], within_tol=ok,
                          tolerance=f"|d| <= {ab} + {rel}*|plain|",
                          ms=time_ms(kernel_only, dev),
                          device_ms=device_ms(kernel_only, dev,
                                              "cycle_kernel"),
                          call_ms=time_ms(call, dev), plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by))
    bad = [c for c in cases if not c["within_tol"]]
    if bad:
        raise AssertionError(f"cycle kernel disagrees with cycle_full: {bad}")
    main = cases[1]  # the trainer passes uniform_te=True
    return dict(
        name=ops.CYCLE_KERNEL.name, route="cuda",
        source=ops.CYCLE_KERNEL.source,
        replaces="ideal_gan_tpu/ops/pallas_ideal.py:168", launches=None,
        max_abs_err=max(max(c["rho_max_abs_err"], c["recon_max_abs_err"])
                        for c in cases),
        ms=main["ms"], device_ms=main["device_ms"], plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        tolerance="|d| <= 1e-5 + 1e-4*|plain| (per-row TE test), "
                  "2e-5 + 2e-4*|plain| (forced uniform recurrence)",
        cases=cases)


def lstm_bwd_flops(nb, size, cin, f, ne=NE, dx=False):
    """(necessary, done) FLOP of one ConvLSTM backward: necessary = one
    forward over all echoes + dinp (dh_{e-1} for e ≥ 1, dx_e if asked) + dk;
    done adds the kernel's recomputes (states of echoes < ne-1, and the
    gates of every echo in the reverse sweep, where the necessary forward
    is counted once)."""
    per = 2 * 9 * 4 * f * nb * size * size  # per input (output) channel
    fwd = per * (cin + (ne - 1) * (cin + f))
    dinp = per * ((ne - 1) * f + (ne * cin if dx else 0))
    dk = fwd
    states = per * (cin + (ne - 2) * (cin + f)) if ne > 1 else 0
    return fwd + dinp + dk, fwd + dinp + dk + states


# the ConvLSTM backward's kernels by name: the state recompute (the forward
# kernel) and the echo sweep's three stages and reduction
BWD_STAGES = {"recompute": LSTM_FWD, "gates": "gates_mma",
              "dinp": "dinp_mma", "dk": "dk_mma", "reduce": "sum_slots"}


def convlstm_bwd_entry(dev, size: int = SIZE, shapes=LSTM_SHAPES) -> dict:
    """The ConvLSTM backward kernels against `convlstm_backward_reference`
    (dx, dk, db) at each (Cin, F, nb) of `shapes`, each on three inputs:

    - "smooth": weights 0.1× He-normal and g-gate bias +1.5, so that every
      g-gate pre-activation and every cell stays positive and no pixel is
      near leaky_relu's kink; the kernel is held to 1e-4 of max |plain| of
      the plain version run in float64 on the same inputs;
    - "negative": as "smooth" with g-gate bias −1.5, so that every g-gate
      pre-activation and every cell stays negative (leaky_relu's 0.2
      branch), held the same way;
    - "random": He-normal weights and random biases, where among the 255 M
      gate values of a batch (1 G at F=72) some lie within float32 rounding
      of the kink, and any two float32 computations take the other branch
      of its derivative (1 or 0.2) at different pixels, each such pixel
      moving dx, dk and db by up to a few % of their scale. Two gates,
      neither of which such a pixel can trip: the launch must equal the
      launches on each pair of samples (dx joined, dk and db summed) to
      1e-4 of max |plain|, which holds the whole batch (the kernels' grid z,
      and the state stack's size) to the same arithmetic and branches; and
      the first pair, with g zeroed where a value lies within 1e-6 of the
      kink (`ops.kink_masked_gradient`: there the derivative taken
      multiplies exact zeros, so no float32 rounding can decide the
      result), is held to the float64 plain version as the kink-free
      inputs are, with both branches taken across its pixels. The whole
      launch's and the unmasked first pair's distances from float64 are
      reported beside them, and the plain f32 version's.

    On the random inputs also: a second launch, which must give dx, dk and
    db bit for bit (`deterministic`); the call timed as the trainer makes
    it (no dx), and split by torch.profiler into the state recompute (the
    forward kernel) and the echo sweep's stages (a) gates, (b) dinp, (c) dk
    and the slot reduction, each beside its bound. The entry reports the
    HMMA instructions `cuobjdump -sass` finds in each stage's kernel."""
    import torch
    from ideal_gan_tpu_torch import ops

    def vs_plain(got, x, k, b, g):
        """{dx, dk, db: errors vs the plain version in f32 and f64}."""
        ref = ops.convlstm_backward_reference(x, k, b, g)
        ref64 = ops.convlstm_backward_reference(
            *(t.double() for t in (x, k, b, g)))
        out = {}
        for name, a, r, t in zip(("dx", "dk", "db"), got, ref, ref64):
            out[name] = dict(max_abs_err=float((a - r).abs().max()),
                             max_abs_err_vs_f64=float(
                                 (a.double() - t).abs().max()),
                             plain_f32_vs_f64=float(
                                 (r.double() - t).abs().max()),
                             scale=float(t.abs().max()))
        return out

    cases, default_size = [], size
    for cin, f, nb, *sz in shapes:
        size = sz[0] if sz else default_size
        for kind in ("smooth", "negative", "random"):
            x, k, b, g = _lstm_inputs(dev, cin, f, nb, size, 10 + cin)
            if kind in KINK_FREE:
                k *= 0.1
                b[2 * f:3 * f] = KINK_FREE[kind]
            got = ops.convlstm_backward(x, k, b, g)
            case = dict(cin=cin, F=f, ne=NE, nb=nb, size=size, inputs=kind,
                        **vs_plain(got, x, k, b, g))
            if kind in KINK_FREE:
                ok = all(c["max_abs_err_vs_f64"] <= 1e-4 * c["scale"]
                         for c in (case["dx"], case["dk"], case["db"]))
            else:
                pairs = [ops.convlstm_backward(x[i:i + 2].contiguous(), k, b,
                                               g[i:i + 2].contiguous())
                         for i in range(0, nb, 2)]
                joined = (torch.cat([p[0] for p in pairs]),
                          sum(p[1] for p in pairs), sum(p[2] for p in pairs))
                first = vs_plain(pairs[0], x[:2].contiguous(), k, b,
                                 g[:2].contiguous())
                gm = ops.kink_masked_gradient(x[:2], k, b, g[:2])
                masked = vs_plain(ops.convlstm_backward(
                    x[:2].contiguous(), k, b, gm), x[:2].contiguous(), k, b,
                    gm)
                case["kink_masked_share"] = float(
                    (gm == 0).all(-1).double().mean())
                del gm
                again = ops.convlstm_backward(x, k, b, g)
                case["deterministic"] = all(
                    torch.equal(a, r) for a, r in zip(got, again))
                del again
                ok = case["deterministic"]
                for name, a, j in zip(("dx", "dk", "db"), got, joined):
                    d = float((a - j).abs().max())
                    fp, mp = first[name], masked[name]
                    case[name].update(
                        vs_pairs=d,
                        first_pair_vs_f64=fp["max_abs_err_vs_f64"],
                        first_pair_plain_f32_vs_f64=fp["plain_f32_vs_f64"],
                        kink_masked_vs_f64=mp["max_abs_err_vs_f64"],
                        kink_masked_plain_f32_vs_f64=mp["plain_f32_vs_f64"],
                        kink_masked_scale=mp["scale"])
                    ok &= d <= 1e-4 * float(j.abs().max())
                    ok &= mp["max_abs_err_vs_f64"] <= 1e-4 * mp["scale"]
                del pairs, joined
            del got
            if kind == "random":
                call = lambda: ops.convlstm_backward(  # noqa: E731
                    x, k, b, g, need_dx=False)
                kernel_ms = time_ms(call, dev, iters=3, warmup=1)
                split = device_ms_by(call, dev, BWD_STAGES)
                plain_ms = time_ms(lambda: ops.convlstm_backward_reference(
                    x, k, b, g, need_dx=False), dev, iters=3, warmup=1)
                # partial yardstick: one echo's weight-gradient convolution
                inp = torch.zeros((nb, cin + f, size, size), device=dev)
                dg = torch.zeros((nb, 4 * f, size, size), device=dev)
                wgrad_ms = time_ms(lambda: torch.nn.grad.conv2d_weight(
                    inp, (4 * f, cin + f, 3, 3), dg, padding=1), dev,
                    iters=5)
                need, done = lstm_bwd_flops(nb, size, cin, f)
                n_bytes = 4 * (x.numel() + 2 * k.numel() + 2 * b.numel()
                               + g.numel())
                b_ms, b_by = bound(n_bytes, need, PEAK_3XTF32_FLOPS)
                states = done - need  # the recompute (the forward kernel)
                case.update(ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by,
                            bound_fp32_ms=bound(n_bytes, need)[0],
                            gflop_necessary=need / 1e9,
                            gflop_done=done / 1e9,
                            cudnn_one_echo_wgrad_ms_partial=wgrad_ms,
                            device_ms=split and sum(split.values()),
                            stages_device_ms=split,
                            recompute=dict(
                                device_ms=split and split["recompute"],
                                bound_ms=bound(0, states,
                                               PEAK_3XTF32_FLOPS)[0],
                                bound_fp32_ms=bound(0, states)[0]),
                            sweep=dict(
                                device_ms=split and sum(
                                    v for n, v in split.items()
                                    if n != "recompute"),
                                bound_ms=b_ms,
                                bound_fp32_ms=bound(0, need)[0]))
                del inp, dg
            case["within_tol"] = ok
            cases.append(case)
            if not ok:
                raise AssertionError(f"convlstm backward disagrees with the "
                                     f"reference: {case}")
            del x, g
            torch.cuda.empty_cache()
    main = cases[2]  # Cin=2, random inputs
    hmma = hmma_counts(ops.CONVLSTM_BWD_KERNEL.name,
                       [v for n, v in BWD_STAGES.items()
                        if n not in ("recompute", "reduce")], "TF32")
    if hmma is not None and not all(hmma.values()):
        raise AssertionError(f"a stage of the ConvLSTM backward has no "
                             f"tensor-core instruction: {hmma}")
    return dict(
        name=ops.CONVLSTM_BWD_KERNEL.name, route="cuda",
        source=ops.CONVLSTM_BWD_KERNEL.source,
        replaces="ideal_gan_tpu/ops/pallas_convlstm.py:517", launches=None,
        max_abs_err=max(c[n]["max_abs_err_vs_f64"] for c in cases
                        if c["inputs"] in KINK_FREE
                        for n in ("dx", "dk", "db")),
        ms=main["ms"], device_ms=main["device_ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], bound_fp32_ms=main["bound_fp32_ms"],
        recompute=main["recompute"], sweep=main["sweep"],
        stages_device_ms=main["stages_device_ms"], hmma=hmma,
        deterministic=all(c["deterministic"] for c in cases
                          if "deterministic" in c),
        library_ms=None,
        tolerance="smooth and negative inputs: |d| <= 1e-4 * max|plain f64| "
                  "for each of dx, dk, db (max_abs_err: the largest, vs the "
                  "plain version in float64); random inputs: the launch vs "
                  "the launches on each pair of samples <= 1e-4 * max|d|, "
                  "and on the first pair, g zeroed around values within "
                  f"{ops.convlstm.KINK_TOL:g} of leaky_relu's kink, |d| "
                  "<= 1e-4 * max|plain f64|; two launches on the random "
                  "inputs bit-identical; bound_ms: 3xTF32 on the tensor "
                  "cores (bound_fp32_ms: FP32 on the CUDA cores)",
        cases=cases, wide=_widest(cases))


# the bf16 storage mode's shapes: AI-DEAL's FM (Cin=2) and R2* (Cin=1) nets
# at F=36, VET-Net's and the 2U-Net R2* net's at F=72, and the GAN
# encoder's (nb=1, 192²); the forward also at the LDM's encode (nb=8, 192²)
LSTM_BF16_SHAPES = ((2, F_MAIN, NB_SERVE), (1, F_MAIN, NB_SERVE),
                    (2, F_TEAUG, NB_SERVE), (1, F_TEAUG, NB_SERVE),
                    (2, F_MAIN, 1, GAN_SIZE))
LSTM_BF16_FWD_ONLY = (LDM_ENCODE_SHAPE,)
LSTM_FWD_BF16 = "convlstm_echo_wg_bf16"
BWD_BF16_STAGES = {"recompute": LSTM_FWD_BF16, "gates": "gates_wg_bf16",
                   "dinp": "dinp_mma_bf16", "dk": "dk_mma_bf16",
                   "reduce": "sum_slots_bf16"}
# the bf16 kernels' SASS: their tensor-core instructions (warpgroup HGMMA,
# warp HMMA), staging (TMA tiled loads UTMALDG, bulk copies UBLKCP,
# cp.async LDGSTS, ldmatrix LDSM) and 16-bit global loads (LDG.E.U16: the
# epilogues' bias and odd-F reads; the mainloops load no operand so)
BF16_SASS = {"HGMMA": ("HGMMA", "BF16"), "HMMA": ("HMMA", "BF16"),
             "UTMALDG": ("UTMALDG",), "UBLKCP": ("UBLKCP",),
             "LDGSTS": ("LDGSTS",), "LDSM": ("LDSM",),
             "LDG16": ("LDG.E.U16",)}
# what each bf16 kernel is built on and must show in its SASS
BF16_CLAIMS = {LSTM_FWD_BF16: ("HGMMA", "UTMALDG", "UBLKCP", "LDSM"),
               "gates_wg_bf16": ("HGMMA", "UTMALDG", "UBLKCP", "LDSM"),
               "dinp_mma_bf16": ("HMMA", "LDGSTS", "LDSM"),
               "dk_mma_bf16": ("HMMA", "LDGSTS", "LDSM")}


def bf16_claims_missing(sass: dict | None) -> list:
    """The (kernel, instruction) pairs of BF16_CLAIMS that `sass`
    (`sass_counts` over BF16_SASS) lacks; none where there is no SASS."""
    if sass is None:
        return []
    return [(k, op) for k, claimed in BF16_CLAIMS.items() if k in sass
            for op in claimed if not sass[k][op]]


def bf16_gate(scale: float) -> float:
    """The bf16 kernels' gate against their plain versions, which round at
    the same points (`ops.convlstm`): the two sum each f32 product in
    another order (~1e-7 relative), which now and then moves a value
    across a bf16 rounding boundary, one ulp (2u of its magnitude, u =
    2^-8) at the echo where it happens. Each of the ne echoes can add at
    most one such ulp, and the recurrence does not amplify it (sigmoid
    gates below 1 scale the carried state; dk and db are sums whose
    final bf16 rounding adds one ulp), so |kernel − plain| ≤ ne · 2u ·
    max|plain|."""
    return NE * 2 * BF16_U * scale


# The share of elements more than one bf16 ulp (2u·|plain|) from the plain
# version a bf16 kernel may have: a summation-order flip moves an element by
# one ulp where it happens and its neighbours downstream by less, so the
# sound kernels sit at ≤ 1.05 % (PERF.md §6); a kernel that skips the
# bf16 rounding points (the f32 kernel's output) sits at 15–24 %.
BF16_ULP_SHARE = 0.02


def bf16_fails(gap: dict) -> bool:
    """Whether a `_bf16_gap` reading breaks the bf16 kernels' gate:
    max |kernel − plain| over `bf16_gate`, or more than BF16_ULP_SHARE of
    the elements beyond one ulp."""
    return (gap["max_abs_err"] > bf16_gate(gap["scale"])
            or gap["share_beyond_1ulp"] > BF16_ULP_SHARE)


def _bf16_gap(got, ref) -> dict:
    """got against ref: the max |difference|, max |ref| and the share of
    elements more than one bf16 ulp (2u·|ref|) apart."""
    got, ref = got.double(), ref.double()
    d = (got - ref).abs()
    return dict(max_abs_err=float(d.max()), scale=float(ref.abs().max()),
                share_beyond_1ulp=float((d > 2 * BF16_U * ref.abs())
                                        .double().mean()))


def _bf16_inputs(dev, cin, f, nb, size, seed, kink=None):
    """convlstm_entry's (kink None: x, k, b) or convlstm_bwd_entry's
    kink-free inputs (x, k, b, g) in float32 (`_lstm_inputs`), and their
    bf16 roundings."""
    import torch
    f32 = _lstm_inputs(dev, cin, f, nb, size, seed, with_g=kink is not None)
    if kink is not None:
        f32[1].mul_(0.1)
        f32[2][2 * f:3 * f] = kink
    return f32, tuple(t.to(torch.bfloat16) for t in f32)


def convlstm_bf16_entries(dev, size: int = SIZE,
                          shapes=LSTM_BF16_SHAPES + LSTM_BF16_FWD_ONLY,
                          fwd_only=LSTM_BF16_FWD_ONLY) -> list:
    """The ConvLSTM kernels' bf16 storage mode (rows 2 and 4 of the kernel
    table) at each (Cin, F, nb) of `shapes` (the backward at those not in
    `fwd_only`), as two `kernels` entries:

    - forward: on convlstm_entry's inputs rounded to bf16, held to the bf16
      plain version (`convlstm_reference` on bf16 tensors) by `bf16_fails`;
      a second launch bit for bit; witnesses: the distance from the f32
      kernel and from the float64 plain version on the float32 inputs; a
      control: the f32 kernel's output must fail that gate;
    - backward: on the kink-free inputs (`KINK_FREE`, smooth and negative)
      rounded to bf16, dx, dk and db held to the bf16 plain version by
      `bf16_fails`; a second launch bit for bit; on the smooth inputs the
      f32-kernel and float64 witnesses, the f32 kernel's dx, dk and db as
      the control (one of them must fail the gate), and the call as the
      trainer makes it (no dx) timed and split by stage.

    Each case reports the share of elements more than one bf16 ulp from
    the plain version, ms beside the bf16 bound (989 TFLOP/s dense bf16;
    bytes at two a value), the plain version's ms, and cuDNN's one-echo
    bf16 gate convolution (forward) or weight gradient (backward) as a
    partial yardstick; each entry its kernels' SASS counts (`BF16_SASS`),
    held to `BF16_CLAIMS`."""
    import torch
    import torch.nn.functional as F
    from ideal_gan_tpu_torch import ops
    fwd_cases, bwd_cases, default_size = [], [], size
    for cin, f, nb, *sz in shapes:
        size = sz[0] if sz else default_size
        (x, k, b), (xb, kb, bb) = _bf16_inputs(dev, cin, f, nb, size, cin)
        call = lambda: ops.convlstm_forward(xb, kb, bb)  # noqa: E731
        out = call()
        deterministic = torch.equal(out, call())
        plain = ops.convlstm_reference(xb, kb, bb)
        gap = _bf16_gap(out, plain)
        out32 = ops.convlstm_forward(x, k, b)
        vs_f32 = _bf16_gap(out, out32)
        control = _bf16_gap(out32, plain)
        control["fails"] = bf16_fails(control)
        vs_f64 = _bf16_gap(out, ops.convlstm_reference(
            x.double(), k.double(), b.double()))
        del out, out32, plain
        npx = nb * size * size
        flops = 2 * 9 * 4 * f * npx * (cin + (NE - 1) * (cin + f))
        n_bytes = 2 * (x.numel() + k.numel() + b.numel() + npx * f)
        b_ms, b_by = bound(n_bytes, flops, PEAK_BF16_FLOPS)
        inp = torch.zeros((nb, cin + f, size, size), device=dev,
                          dtype=torch.bfloat16)
        w = kb.permute(3, 2, 0, 1).contiguous()
        case = dict(
            cin=cin, F=f, ne=NE, nb=nb, size=size, **gap,
            deterministic=deterministic,
            vs_f32_kernel=vs_f32, f32_kernel_control=control,
            vs_plain_f64=vs_f64,
            ms=time_ms(call, dev, iters=5),
            device_ms=device_ms(call, dev, LSTM_FWD_BF16, iters=3),
            plain_ms=time_ms(lambda: ops.convlstm_reference(xb, kb, bb), dev,
                             iters=3),
            bound_ms=b_ms, bound_by=b_by, gflop=flops / 1e9,
            cudnn_one_echo_gate_conv_bf16_ms_partial=time_ms(
                lambda: F.conv2d(inp, w, padding=1), dev, iters=5))
        fwd_cases.append(case)
        if bf16_fails(gap) or not deterministic or not control["fails"]:
            raise AssertionError(f"bf16 convlstm forward disagrees with its "
                                 f"plain version, or the f32 kernel's output "
                                 f"passes its gate: {case}")
        del x, xb, inp
        if (cin, f, nb, *sz) in fwd_only:
            continue
        for kind, g_bias in KINK_FREE.items():
            (x, k, b, g), (xb, kb, bb, gb) = _bf16_inputs(
                dev, cin, f, nb, size, 10 + cin, g_bias)
            got = ops.convlstm_backward(xb, kb, bb, gb)
            again = ops.convlstm_backward(xb, kb, bb, gb)
            case = dict(cin=cin, F=f, ne=NE, nb=nb, size=size, inputs=kind,
                        deterministic=all(torch.equal(a, r)
                                          for a, r in zip(got, again)))
            del again
            ref = ops.convlstm_backward_reference(xb, kb, bb, gb)
            for name, a, r in zip(("dx", "dk", "db"), got, ref):
                case[name] = _bf16_gap(a, r)
            if kind != "smooth":
                del ref
            else:
                f32 = ops.convlstm_backward(x, k, b, g)
                for name, a, r, p in zip(("dx", "dk", "db"), got, f32, ref):
                    case[name]["vs_f32_kernel"] = _bf16_gap(a, r)
                    case[name]["f32_kernel_control"] = _bf16_gap(r, p)
                case["f32_kernel_control_fails"] = any(
                    bf16_fails(case[n]["f32_kernel_control"])
                    for n in ("dx", "dk", "db"))
                del f32, ref
                f64 = ops.convlstm_backward_reference(
                    *(t.double() for t in (x, k, b, g)))
                for name, a, r in zip(("dx", "dk", "db"), got, f64):
                    case[name]["vs_plain_f64"] = _bf16_gap(a, r)
                del f64
                call = lambda: ops.convlstm_backward(  # noqa: E731
                    xb, kb, bb, gb, need_dx=False)
                need, _ = lstm_bwd_flops(nb, size, cin, f)
                n_bytes = 2 * (x.numel() + 2 * k.numel() + 2 * b.numel()
                               + g.numel())
                b_ms, b_by = bound(n_bytes, need, PEAK_BF16_FLOPS)
                inp = torch.zeros((nb, cin + f, size, size), device=dev,
                                  dtype=torch.bfloat16)
                dg = torch.zeros((nb, 4 * f, size, size), device=dev,
                                 dtype=torch.bfloat16)
                split = device_ms_by(call, dev, BWD_BF16_STAGES)
                case.update(
                    ms=time_ms(call, dev, iters=3, warmup=1),
                    device_ms=split and sum(split.values()),
                    stages_device_ms=split,
                    plain_ms=time_ms(lambda: ops.convlstm_backward_reference(
                        xb, kb, bb, gb, need_dx=False), dev, iters=2,
                        warmup=1),
                    bound_ms=b_ms, bound_by=b_by,
                    gflop_necessary=need / 1e9,
                    cudnn_one_echo_wgrad_bf16_ms_partial=time_ms(
                        lambda: torch.nn.grad.conv2d_weight(
                            inp, (4 * f, cin + f, 3, 3), dg, padding=1),
                        dev, iters=5))
                del inp, dg
            bwd_cases.append(case)
            del got, x, xb, g, gb
            if not case["deterministic"] or any(
                    bf16_fails(case[n]) for n in ("dx", "dk", "db")) \
                    or not case.get("f32_kernel_control_fails", True):
                raise AssertionError(f"bf16 convlstm backward disagrees with "
                                     f"its plain version, or the f32 "
                                     f"kernel's output passes its gate: "
                                     f"{case}")
            torch.cuda.empty_cache()
    sass_fwd = sass_counts(ops.CONVLSTM_BF16_KERNEL.lib, [LSTM_FWD_BF16],
                           BF16_SASS)
    sass_bwd = sass_counts(ops.CONVLSTM_BWD_BF16_KERNEL.lib,
                           [BWD_BF16_STAGES[n] for n in ("gates", "dinp",
                                                          "dk")], BF16_SASS)
    missing = bf16_claims_missing(sass_fwd) + bf16_claims_missing(sass_bwd)
    if missing:
        raise AssertionError(f"a bf16 ConvLSTM kernel lacks the instructions "
                             f"it is built on: {missing} ({sass_fwd}, "
                             f"{sass_bwd})")
    tol = ("|kernel - plain bf16| <= ne * 2u * max|plain| (u = 2^-8, "
           "bf16_gate) and at most 2 % of the elements beyond one ulp "
           "(BF16_ULP_SHARE); the f32 kernel's output fails that gate; two "
           "launches bit-identical; bound_ms: dense bf16 on the tensor "
           "cores, two bytes a value")
    timed = [c for c in bwd_cases if "ms" in c]
    fwd_main, bwd_main = fwd_cases[0], timed[0]
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")
    return [
        dict(name=ops.CONVLSTM_BF16_KERNEL.name, route="cuda",
             source=ops.CONVLSTM_BF16_KERNEL.source,
             replaces="ideal_gan_tpu/ops/pallas_convlstm.py:177",
             launches=None,
             max_abs_err=max(c["max_abs_err"] for c in fwd_cases),
             **{k: fwd_main[k] for k in keys}, library_ms=None,
             sass=sass_fwd, deterministic=all(c["deterministic"]
                                              for c in fwd_cases),
             tolerance=tol, cases=fwd_cases,
             wide={k: fwd_cases[2][k] for k in ("cin", "F", "nb") + keys}),
        dict(name=ops.CONVLSTM_BWD_BF16_KERNEL.name, route="cuda",
             source=ops.CONVLSTM_BWD_BF16_KERNEL.source,
             replaces="ideal_gan_tpu/ops/pallas_convlstm.py:517",
             launches=None,
             max_abs_err=max(c[n]["max_abs_err"] for c in bwd_cases
                             for n in ("dx", "dk", "db")),
             **{k: bwd_main[k] for k in keys},
             stages_device_ms=bwd_main["stages_device_ms"], library_ms=None,
             sass=sass_bwd, deterministic=all(c["deterministic"]
                                              for c in bwd_cases),
             tolerance=tol + "; kink-free inputs", cases=bwd_cases,
             wide={k: timed[2][k] for k in ("cin", "F", "nb") + keys})]


def forward_entry(dev, size: int = SIZE, nb: int = NB_SERVE) -> dict:
    """The synthesis kernel against `physics.synthesize` on the same inputs:
    MEBCRN maps with R2* in [-0.1, 0.5] (the clamp at 0 is hit), at a
    jittered TE train from `sample_te_train` (the trainer's per-echo call,
    and the per-row test) and at a uniform one (the forced recurrence, and
    the per-row test)."""
    import numpy as np
    import torch
    from ideal_gan_tpu_torch import ops, physics
    from ideal_gan_tpu_torch.ops import ideal
    from ideal_gan_tpu_torch.physics import constants as pc
    rng = np.random.default_rng(4)
    shape = (nb, size, size)
    maps = np.zeros((nb, 3, size, size, 2), np.float32)
    maps[:, :2] = rng.uniform(-0.5, 0.7, (nb, 2, size, size, 2))
    maps[:, 2, ..., 0] = rng.uniform(-0.3, 0.3, shape)
    maps[:, 2, ..., 1] = rng.uniform(-0.1, 0.5, shape)
    maps = torch.from_numpy(maps).to(dev)
    tes = {"jittered": physics.sample_te_train(
        torch.Generator().manual_seed(0), NE, nb, device=dev),
        "uniform": physics.te_train(NE, bs=nb, device=dev)}
    nv = nb * size * size
    # read ρ 16 + (φ, R2*) 8, write 8·ne bytes a voxel
    b_ms, b_by = bound(nv * (16 + 8 + NE * 8), nv * NE * 24)
    cases = []
    for te_kind, flag, rel, ab in (("jittered", False, 1e-4, 1e-5),
                                   ("jittered", None, 1e-4, 1e-5),
                                   ("uniform", True, 2e-4, 2e-5),
                                   ("uniform", None, 1e-4, 1e-5)):
        te = tes[te_kind]
        plain = lambda: physics.synthesize(maps, te)  # noqa: E731
        ref = plain()
        pre = ops.precompute_synth_matrices(te)
        call = lambda: ops.synthesize_fused(  # noqa: E731
            maps, te, uniform_te=flag)
        kernel_only = call if dev.type == "cpu" else (
            lambda: ideal._synth_kernel(
                maps, te, 1.5, pc.R2_SC, pc.FM_SC, pc.RHO_SC,
                pc.WATER_FAT_7PEAK, flag, pre))
        out = kernel_only()
        ok = bool(((out - ref).abs() <= ab + rel * ref.abs()).all())
        cases.append(dict(te=te_kind, uniform_te=flag, nb=nb, ne=NE,
                          size=size,
                          max_abs_err=float((out - ref).abs().max()),
                          ref_max_abs=float(ref.abs().max()), within_tol=ok,
                          tolerance=f"|d| <= {ab} + {rel}*|plain|",
                          ms=time_ms(kernel_only, dev),
                          device_ms=device_ms(kernel_only, dev,
                                              "synth_kernel"),
                          call_ms=time_ms(call, dev),
                          plain_ms=time_ms(plain, dev), bound_ms=b_ms,
                          bound_by=b_by))
    bad = [c for c in cases if not c["within_tol"]]
    if bad:
        raise AssertionError(f"synthesis kernel disagrees with synthesize: "
                             f"{bad}")
    main = cases[0]  # the trainer passes a jittered TE and uniform_te=False
    return dict(
        name=ops.FORWARD_KERNEL.name, route="cuda",
        source=ops.FORWARD_KERNEL.source,
        replaces="ideal_gan_tpu/ops/pallas_ideal.py:200", launches=None,
        max_abs_err=max(c["max_abs_err"] for c in cases), ms=main["ms"],
        device_ms=main["device_ms"], plain_ms=main["plain_ms"],
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        tolerance="|d| <= 1e-5 + 1e-4*|plain| (per-echo form and per-row TE "
                  "test), 2e-5 + 2e-4*|plain| (forced uniform recurrence)",
        clamped_share=float((maps[:, 2, ..., 1] < 0).float().mean()),
        cases=cases)


def mag_fit_entry(dev, size: int = SIZE, nb: int = NB_SERVE) -> dict:
    """The magnitude fit kernel against `physics.cse_mag_fit` on the same
    inputs: the magnitudes of bench.py's synthetic echoes (and of the same
    maps synthesized at a jittered TE train) with R2* 0.02 off the truth,
    in channel 0 of a (nb, 1, H, W, 1) row. Each output is held to the JAX
    package's rtol 1e-3 / atol 5e-4 (voxels on the 1e-6 and λmax > 0
    thresholds may flip under another summation order); the count of
    voxels beyond 1e-5 + 1e-4·|plain| is reported beside it."""
    import torch
    from ideal_gan_tpu_torch import ops, physics
    from ideal_gan_tpu_torch.ops import ideal
    from ideal_gan_tpu_torch.physics import constants as pc
    _, maps, te_u = bench_inputs(nb, size, dev)
    r2 = (maps[:, 2:3, ..., 1:] + 0.02).contiguous()
    tes = {"uniform": te_u, "jittered": physics.sample_te_train(
        torch.Generator().manual_seed(6), NE, nb, device=dev)}
    nv = nb * size * size
    # read |S| 4·ne + R2* 4, write ρ 8 + |Ŝ| 4·ne + LS 12 + ratio 4 bytes
    # a voxel; per echo 8 FLOP of the LS sums and 6 of the reprojection
    b_ms, b_by = bound(nv * (8 * NE + 28), nv * (14 * NE + 30))
    names = ("rho", "recon", "ls_coeffs", "uncertainty")
    cases = []
    for te_kind, flag in (("uniform", None), ("uniform", True),
                          ("jittered", None), ("jittered", False)):
        te = tes[te_kind]
        acqs = physics.synthesize(maps, te)
        a_mag = acqs.square().sum(-1, keepdim=True).sqrt()
        plain = lambda: physics.cse_mag_fit(a_mag, r2, te)  # noqa: E731
        ref = plain()
        pre = ops.precompute_mag_matrices(te)
        call = lambda: ops.cse_mag_fused(  # noqa: E731
            a_mag, r2, te, uniform_te=flag)
        kernel_only = (lambda: tuple(getattr(call(), n) for n in names)) \
            if dev.type == "cpu" else (lambda: ideal._mag_fit_kernel(
                a_mag, r2, te, 1.5, pc.R2_SC, pc.RHO_SC, pc.WATER_FAT_7PEAK,
                flag, pre))
        got = kernel_only()
        case = dict(te=te_kind, uniform_te=flag, nb=nb, ne=NE, size=size)
        ok = True
        for name, out in zip(names, got):
            r = getattr(ref, name)
            d = (out - r).abs()
            if name == "rho":
                ok &= _mag_rho_ok(out, r, ref.ls_coeffs)
                case["rho_f64"] = _mag_rho_vs_f64(out, r, ref.ls_coeffs)
                case["rho_within_tol_every_voxel"] = bool(
                    (d <= 5e-4 + 1e-3 * r.abs()).all())
            else:
                ok &= bool((d <= 5e-4 + 1e-3 * r.abs()).all())
            case[name] = dict(max_abs_err=float(d.max()),
                              ref_max_abs=float(r.abs().max()),
                              beyond_1e_5_1e_4=int(
                                  (d > 1e-5 + 1e-4 * r.abs()).sum()))
        case.update(within_tol=ok, ms=time_ms(kernel_only, dev),
                    device_ms=device_ms(kernel_only, dev, "mag_ls_kernel"),
                    call_ms=time_ms(call, dev), plain_ms=time_ms(plain, dev),
                    bound_ms=b_ms, bound_by=b_by)
        cases.append(case)
    bad = [c for c in cases if not c["within_tol"]]
    if bad:
        raise AssertionError(f"magnitude fit kernel disagrees with "
                             f"cse_mag_fit: {bad}")
    main = cases[0]  # the trainer and Mag serving: uniform TE, per-row test
    return dict(
        name=ops.MAG_FIT_KERNEL.name, route="cuda",
        source=ops.MAG_FIT_KERNEL.source,
        replaces="ideal_gan_tpu/ops/pallas_ideal.py:621", launches=None,
        max_abs_err=max(c[n]["max_abs_err"] for c in cases for n in names),
        ms=main["ms"], device_ms=main["device_ms"], plain_ms=main["plain_ms"],
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        tolerance="|d| <= 5e-4 + 1e-3*|plain| (the JAX package's) for "
                  "recon, ls_coeffs, uncertainty, and rho where |b| >= "
                  "1e-3*|a - c| (elsewhere the closed form's fat part "
                  "cancels: rho_f64, _mag_rho_ok); beyond_1e_5_1e_4 counts "
                  "the elements outside 1e-5 + 1e-4*|plain|",
        cases=cases)


def _mag_rho_well(ls):
    """Voxels whose 2×2 eigenvector the closed form gets in float32: where
    |b| < 1e-3·|a − c| its fat part λmax − a = √((a−c)²/4 + b²/4) − (a−c)/2
    cancels, and float32's rounding of a few 1e-8·|a − c| is a large share
    of it (b ≈ 0 where the fitted fat is 0, or where an R2* off the truth
    bends the LS coefficients)."""
    a, b, c = ls[:, 0], ls[:, 1], ls[:, 2]
    return b.abs() >= 1e-3 * (a - c).abs()  # (nb, H, W, 1)


def _mag_rho_ok(rho, rho_ref, ls) -> bool:
    """ρ against the plain version where the eigenvector is well-conditioned
    (`_mag_rho_well`; both components, 5e-4 + 1e-3·|plain|), and the other
    voxels under 1 % of all. Elsewhere neither float32 closed form holds
    ρ's direction, nor its norm once |b| nears the 1e-12 inside √."""
    d = (rho - rho_ref).abs()
    well = _mag_rho_well(ls)[:, None].expand_as(d)
    return bool((d <= 5e-4 + 1e-3 * rho_ref.abs())[well].all()
                and (~well).float().mean() < 0.01)


def _mag_rho_vs_f64(rho, rho_ref, ls) -> dict:
    """The voxels outside `_mag_rho_well` and how far the kernel's and the
    plain version's ρ there are from the float64 eigensolve of the plain
    version's LS coefficients: both float32 closed forms, not the kernel."""
    from ideal_gan_tpu_torch import physics
    from ideal_gan_tpu_torch.physics import constants as pc
    x = (ls.double() * pc.RHO_SC ** 2)[..., 0].permute(0, 2, 3, 1)
    rho64 = physics.eigenvals_2x2(x)[0].permute(0, 3, 1, 2)[..., None]
    rho64 = rho64 / pc.RHO_SC
    bad = ~_mag_rho_well(ls)[:, None].expand_as(rho)
    if not bool(bad.any()):
        return dict(cancelling_voxels=0)
    return dict(cancelling_voxels=int(bad[:, 0].sum()),
                kernel_vs_f64=float((rho.double() - rho64).abs()[bad].max()),
                plain_vs_f64=float((rho_ref.double() - rho64).abs()[bad]
                                   .max()))


def _grads(net):
    return {n: p.grad.detach().cpu() for n, p in net.named_parameters()
            if p.grad is not None}


@contextlib.contextmanager
def plain_convlstm(noise: tuple[float, int] | None = None):
    """The ConvLSTM Function on its plain versions (`convlstm_reference`,
    `convlstm_backward_reference`) on every device: the kernels taken out,
    for the witness runs of the step parities only. With `noise` = (eps,
    seed), the forward's output gets eps·max|h|·N(0, 1) added (a seeded
    perturbation of the size of float32 rounding)."""
    import torch
    from ideal_gan_tpu_torch.ops import convlstm as mod
    saved = mod.convlstm_forward, mod.convlstm_backward

    def noisy(*args):
        out = mod.convlstm_reference(*args)
        gen = torch.Generator(device=out.device).manual_seed(noise[1])
        return out + noise[0] * float(out.abs().max()) * torch.randn(
            out.shape, generator=gen, device=out.device)

    mod.convlstm_forward = noisy if noise else mod.convlstm_reference
    mod.convlstm_backward = mod.convlstm_backward_reference
    try:
        yield
    finally:
        mod.convlstm_forward, mod.convlstm_backward = saved


def _trace(net):
    """Forward hooks on every module of `net` that keep its output and the
    gradient reaching that output and its first input. Returns (outs,
    grads, order, handles); `order` lists the gradients' keys as the
    backward reaches them ("name" an output, "name<in" an input)."""
    import torch
    outs, grads, order = {}, {}, []

    def keep(key):
        def fn(g):
            order.append(key)
            grads[key] = g.detach().cpu()
        return fn

    def hook(name):
        def fn(mod, inputs, out):
            if not isinstance(out, torch.Tensor):  # nn.LSTM's (y, (h, c))
                return
            outs[name] = out.detach().cpu()
            if out.requires_grad:
                out.register_hook(keep(name))
            if inputs and isinstance(inputs[0], torch.Tensor) \
                    and inputs[0].requires_grad:
                inputs[0].register_hook(keep(name + "<in"))
        return fn

    handles = [m.register_forward_hook(hook(n or "unet"))
               for n, m in net.named_modules()]
    return outs, grads, order, handles


def _steps(cfg, nets, acqs, te, where, steps, plain=False, trace=False):
    """The FM and/or R2 step's loss and the trained net's gradient leaves on
    `where`; with `trace`, also g_fm's module outputs and gradients."""
    import torch
    from ideal_gan_tpu_torch.train import unsup
    A = torch.from_numpy(acqs).to(where)
    t = torch.from_numpy(te).to(where)
    off = torch.zeros((), device=where)
    makes = {"fm": (unsup.make_loss_fn, 0), "r2": (unsup.make_r2_loss_fn, 1)}
    res = {}
    for step in steps:
        make, i = makes[step]
        for n in nets:
            n.zero_grad()
        traced = _trace(nets[0]) if trace else None
        with plain_convlstm() if plain else contextlib.nullcontext():
            loss, _ = make(cfg, *nets)(off, A, t)
            loss.backward()
        res[step] = dict(loss=float(loss.detach()), grads=_grads(nets[i]))
        if traced:
            for h in traced[3]:
                h.remove()
            res[step]["trace"] = traced[:3]
    return res


def _rel(a, b) -> float:
    """max |a − b| over max |b| (over 1 where b is all zero)."""
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / (scale if scale > 0 else 1.0)


def _rel_diff(x: float, ref: float) -> float:
    """|x − ref| over |ref| (the absolute difference where ref is 0)."""
    return abs(x - ref) / (abs(ref) if ref else 1.0)


def _compare(run, ref) -> dict:
    """Loss and gradient leaves of one step's run against a reference run."""
    if set(run["grads"]) != set(ref["grads"]):
        raise AssertionError("gradient leaves differ")
    g, g_ref = run["grads"], ref["grads"]
    scale = max(float(v.abs().max()) for v in g_ref.values())
    worst = max(g_ref, key=lambda n: float((g[n] - g_ref[n]).abs().max()))
    return dict(
        loss=run["loss"], loss_ref=ref["loss"],
        loss_rel_diff=_rel_diff(run["loss"], ref["loss"]),
        grad_max_rel=float((g[worst] - g_ref[worst]).abs().max())
        / max(scale, 1e-12),
        grad_worst_leaf=worst, grad_scale=scale, leaves=len(g_ref))


def _pool_routes(x, x_ref) -> dict:
    """2×2 max-pool windows of one max-pool input on two devices: the share
    with an exact tie on each, and the share where the two route the
    gradient to another pixel."""
    import torch.nn.functional as F
    nb, c, h, w = x.shape

    def ties(t):
        win = t.reshape(nb, c, h // 2, 2, w // 2, 2)
        top = win.amax(dim=(3, 5), keepdim=True)
        return float(((win == top).sum(dim=(3, 5)) > 1).float().mean())

    idx = F.max_pool2d(x, 2, return_indices=True)[1]
    idx_ref = F.max_pool2d(x_ref, 2, return_indices=True)[1]
    return dict(ties=ties(x), ties_ref=ties(x_ref),
                routed_elsewhere=float((idx != idx_ref).float().mean()))


def _signs(z, z_ref) -> dict:
    """One tensor on two devices: the share of exact zeros on each, the
    largest |z| where z_ref is exactly zero, and the share of elements where
    z > 0 differs (where a ReLU on it passes its gradient)."""
    ref_zero = z_ref == 0
    return dict(zeros=float((z == 0).float().mean()),
                zeros_ref=float(ref_zero.float().mean()),
                max_abs_where_ref_zero=float(z[ref_zero].abs().max())
                if bool(ref_zero.any()) else 0.0,
                mask_differs=float(((z > 0) != (z_ref > 0)).float().mean()))


def step_parity(dev, size: int, batch: int, f: int) -> dict:
    """One FM step's and one R2 step's loss and gradients on `dev` and on
    the CPU from the same weights and batch (TF32 off on the card).

    The gated batch is the synthetic cohort plus N(0, 1e-3) noise, as real
    acquisitions carry. The cohort itself is exactly zero outside its mask;
    on it the card's gradients differ from the CPU's by more than the
    tolerance (PERF.md §7). A witness measures that case: the FM step on
    the noise-free batch on the card with the kernels, on the card with the
    plain ConvLSTM in their place (`plain_convlstm`), and on the CPU, each
    card run compared with the CPU and the two card runs with each other;
    how far the card's forward values and gradients are from the CPU's at
    every module of g_fm; how the max-pools route, and where the ReLUs
    (and the ConvLSTM output before the first) are exactly zero and pass on
    each device. `main` holds its loss and forward values, not its
    gradients. The noisy batch's steps also run with the plain ConvLSTM on
    the card."""
    import copy

    import numpy as np
    import torch
    from ideal_gan_tpu_torch.cli.common import synthetic_dataset
    from ideal_gan_tpu_torch.train import unsup

    cpu = torch.device("cpu")
    cfg = dict(unsup.DEFAULTS, n_G_filters=f, out_vars="PM")
    clean, _, te = synthetic_dataset(batch, h=size, w=size, ne=NE, seed=1)
    noisy = clean + 1e-3 * np.random.default_rng(2).normal(
        size=clean.shape).astype(np.float32)
    g_fm, g_r2 = unsup.build_models(cfg)
    gen = torch.Generator().manual_seed(3)
    g_fm.init_params(gen)
    g_r2.init_params(gen)

    def run(acqs, where, steps, **kw):
        nets = [copy.deepcopy(n).to(where) for n in (g_fm, g_r2)]
        return _steps(cfg, nets, acqs, te, where, steps, **kw)

    out = {}
    card = run(noisy, dev, ("fm", "r2"))
    card_plain = run(noisy, dev, ("fm", "r2"), plain=True)
    ref = run(noisy, cpu, ("fm", "r2"))
    for step in ("fm", "r2"):
        out[step] = _compare(card[step], ref[step])
        out[step]["plain_convlstm_on_card_vs_cpu"] = _compare(
            card_plain[step], ref[step])["grad_max_rel"]

    card = run(clean, dev, ("fm",), trace=True)["fm"]
    card_plain = run(clean, dev, ("fm",), plain=True)["fm"]
    ref = run(clean, cpu, ("fm",), trace=True)["fm"]
    outs, grads, _ = card["trace"]
    outs_ref, grads_ref, order_ref = ref["trace"]
    fwd = [[n, _rel(outs[n], t)] for n, t in outs_ref.items()]
    bwd = [[k, _rel(grads[k], grads_ref[k])] for k in order_ref]
    out["zero_background_fm"] = dict(
        card_vs_cpu=_compare(card, ref),
        plain_convlstm_on_card_vs_cpu=_compare(card_plain, ref),
        card_vs_plain_convlstm_on_card=_compare(card, card_plain),
        first_forward_over_1e_3=next((n for n, r in fwd if r > 1e-3), None),
        first_gradient_over_1e_2=next((k for k, r in bwd if r > 1e-2), None),
        maxpool={n: _pool_routes(outs[n], outs_ref[n])
                 for n in outs_ref if n.count(".") == 1
                 and n.startswith("down.")},
        lstm_out=_signs(outs["lstm"], outs_ref["lstm"]),
        relu={n: _signs(outs[n], outs_ref[n]) for n in outs_ref
              if n.endswith((".conv1", ".conv2"))},
        forward_rel=fwd, gradient_rel=bwd)
    return out


def train_phase(dev, out_dir: Path, size: int = SIZE, n: int = 16,
                batch: int = NB_SERVE, f: int = F_MAIN,
                parity_size: int = 192, parity_batch: int = 2) -> dict:
    """The training CLI on the card with the launch counters read around
    it, then the card-vs-CPU step parity."""
    import math

    from ideal_gan_tpu_torch.cli import train_unsup

    argv = ["--synthetic", str(n), "--data_size", str(size), "--batch_size",
            str(batch), "--epochs", "2", "--out_vars", "PM", "--n_G_filters",
            str(f), "--seed", "0", "--device", str(dev), "--output_base",
            str(out_dir)]
    result, wall, launches, peak = counted_peak(
        dev, lambda: train_unsup.main(argv))
    losses = [v for ep in result["epochs"] for k, v in ep.items()
              if k.endswith("loss")]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train losses not finite: {result['epochs']}")
    state = result["state"]
    no_grad = [f"{net}.{n}" for net in ("g_fm", "g_r2")
               for n, p in getattr(state, net).lstm.named_parameters()
               if p.grad is None or not bool(p.grad.abs().max() > 0)]
    if no_grad:
        raise AssertionError(f"ConvLSTM parameters without a gradient: "
                             f"{no_grad}")
    last = result["epochs"][-1]
    step_ms = last["seconds"] / last["steps"] * 1e3
    set_tf32(False)
    parity = step_parity(dev, parity_size, parity_batch, f)
    return dict(launches=launches, wall_s=wall, epochs=result["epochs"],
                peak_memory_gb=peak, ms_per_step_pair=step_ms,
                slices_per_s=batch * 1e3 / step_ms, parity=parity,
                parity_shape=dict(size=parity_size, batch=parity_batch, F=f))


def teaug_step_parity(dev, size: int, batch: int, f: int) -> dict:
    """One generator step's loss, metrics and gradients on `dev` and on the
    CPU from the same weights, maps, TE train and noise (TF32 off on the
    card). The synthesized acquisitions carry N(0, 0.1²) noise everywhere,
    so the exactly zero background of the AI-DEAL step parity (PERF.md §7)
    does not arise.

    Witnesses of where the gradient residue comes from: the card step with
    the plain ConvLSTM in place of its kernels; both steps against the CPU
    step with the net in float64 (the physics stays float32, the same on
    all three), and against it also the card step with the plain ConvLSTM
    and with the plain ConvLSTM's output perturbed by 1e-7 of its scale
    (four seeds), as the magnitude witness has them; and both f32 steps
    traced as the AI-DEAL witness is: how
    far the card's gradient is from the CPU's at every module, and, at each
    ReLU'd convolution, how many outputs lie on the other side of 0 on the
    card (where the ReLU passes the gradient on one device only)."""
    import copy

    import numpy as np
    import torch
    from ideal_gan_tpu_torch import physics
    from ideal_gan_tpu_torch.cli.common import synthetic_dataset
    from ideal_gan_tpu_torch.train import teaug

    cpu = torch.device("cpu")
    cfg = dict(teaug.DEFAULTS, n_G_filters=f)
    _, maps, _ = synthetic_dataset(batch, h=size, w=size, ne=NE, seed=1)
    B = torch.from_numpy(maps)
    te = physics.sample_te_train(torch.Generator().manual_seed(2), NE, batch)
    noise = torch.from_numpy(np.random.default_rng(3).normal(
        size=(batch, NE, size, size, 2)).astype(np.float32))
    model = teaug.build_model(cfg)
    model.init_params(torch.Generator().manual_seed(4))

    def run(where, plain=False, dtype=torch.float32, trace=False,
            perturb=None):
        net = copy.deepcopy(model).to(device=where, dtype=dtype)
        traced = _trace(net) if trace else None
        with plain_convlstm(perturb) if plain or perturb \
                else contextlib.nullcontext():
            loss, metrics = teaug.make_loss_fn(cfg, net)(
                B.to(where), te.to(where), noise.to(where))
            loss.backward()
        if traced:
            for h in traced[3]:
                h.remove()
        return dict(loss=float(loss.detach()), grads=_grads(net),
                    metrics={k: float(v.detach())
                             for k, v in metrics.items()},
                    trace=traced[:3] if traced else None)

    card, ref = run(dev, trace=True), run(cpu, trace=True)
    ref64 = run(cpu, dtype=torch.float64)
    out = _compare(card, ref)
    out["metrics"], out["metrics_ref"] = card["metrics"], ref["metrics"]
    out["metrics_rel_diff"] = {k: _rel_diff(v, ref["metrics"][k])
                               for k, v in card["metrics"].items()}
    plain = run(dev, plain=True)
    out["plain_convlstm_on_card_vs_cpu"] = _compare(plain,
                                                    ref)["grad_max_rel"]
    out["vs_cpu_float64"] = {
        "card": _compare(card, ref64)["grad_max_rel"],
        "cpu": _compare(ref, ref64)["grad_max_rel"],
        "card_plain_convlstm": _compare(plain, ref64)["grad_max_rel"],
        "card_plain_convlstm_perturbed_1e_7": [
            _compare(run(dev, perturb=(1e-7, seed)), ref64)["grad_max_rel"]
            for seed in range(4)]}
    outs, grads, _ = card["trace"]
    outs_ref, grads_ref, order_ref = ref["trace"]
    bwd = [[k, _rel(grads[k], grads_ref[k])] for k in order_ref]
    out["first_gradient_over_1e_2"] = next(
        (k for k, r in bwd if r > 1e-2), None)
    convs = [n for n in outs_ref if n.endswith((".conv1", ".conv2"))]
    flips = {n: int(((outs[n] > 0) != (outs_ref[n] > 0)).sum())
             for n in convs}
    out["relu_flips"] = {n: c for n, c in flips.items() if c}
    out["relu_outputs"] = sum(outs_ref[n].numel() for n in convs)
    out["gradient_rel"] = bwd
    return out


def teaug_phase(dev, out_dir: Path, size: int = SIZE, n: int = 16,
                batch: int = NB_SERVE, f: int = F_TEAUG,
                parity_size: int = 96, parity_batch: int = 2) -> dict:
    """The TE-augmentation training CLI on the card with the launch
    counters read around it, then the card-vs-CPU generator step."""
    import math

    from ideal_gan_tpu_torch.cli import train_teaug

    argv = ["--synthetic", str(n), "--data_size", str(size), "--batch_size",
            str(batch), "--epochs", "2", "--n_G_filters", str(f), "--seed",
            "0", "--device", str(dev), "--output_base", str(out_dir)]
    result, wall, launches = counted(dev, lambda: train_teaug.main(argv))
    losses = [v for ep in result["epochs"] for k, v in ep.items()
              if k.endswith("loss")]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"teaug losses not finite: {result['epochs']}")
    model = result["state"].model
    no_grad = [n for n, p in model.named_parameters()
               if p.requires_grad and n.startswith(("lstm.", "encoder.te."))
               and (p.grad is None or not bool(p.grad.abs().max() > 0))]
    if no_grad:
        raise AssertionError(f"ConvLSTM / TEEncoder parameters without a "
                             f"gradient: {no_grad}")
    last = result["epochs"][-1]
    step_ms = last["seconds"] / last["steps"] * 1e3
    set_tf32(False)
    parity = teaug_step_parity(dev, parity_size, parity_batch, f)
    return dict(launches=launches, steps=result["state"].step, wall_s=wall,
                epochs=result["epochs"], ms_per_step=step_ms,
                slices_per_s=batch * 1e3 / step_ms, parity=parity,
                parity_shape=dict(size=parity_size, batch=parity_batch, F=f))


def e2e_phase(dev, out_dir: Path, size: int = SIZE, n: int = 16,
              batch: int = NB_SERVE) -> dict:
    """The serving CLI on the card with the launch counters read around it,
    then the first chunk on the card and on the CPU, compared."""
    import numpy as np
    from ideal_gan_tpu_torch.cli import infer, roi_analysis
    from ideal_gan_tpu_torch.cli.common import load_cohorts

    argv = ["--model_sel", "AI-DEAL", "--synthetic", str(n), "--data_size",
            str(size), "--infer_batch", str(batch), "--export", "npz",
            "--seed", "0", "--device", str(dev), "--output_base",
            str(out_dir)]
    maps, wall, launches = counted(dev, lambda: infer.main(argv))
    if maps.shape != (n, 3, size, size, 2) or not np.isfinite(maps).all():
        raise AssertionError(f"e2e maps shape {maps.shape} or not finite")
    with np.load(out_dir / "infer" / "maps_pred.npz") as npz:
        slices_per_s = float(npz["slices_per_s"])

    cfg = dict(infer.DEFAULTS, model_sel="AI-DEAL", seed=0, synthetic=n,
               data_size=size)
    acqs, _, te = load_cohorts(cfg)
    a, t = acqs[:batch], te[:batch]
    set_tf32(False)
    dev_maps = roi_analysis._per_slice(
        roi_analysis.make_infer_run(cfg, a, dev), a, t, batch, dev)[0]
    t_cpu = time.perf_counter()
    cpu_maps = roi_analysis._per_slice(
        roi_analysis.make_infer_run(cfg, a, "cpu"), a, t, batch, "cpu")[0]
    cpu_s = time.perf_counter() - t_cpu
    pd_dev, _, _ = infer.maps_to_display(dev_maps)
    pd_cpu, _, _ = infer.maps_to_display(cpu_maps)
    maps_err = float(np.abs(dev_maps - cpu_maps).max())
    # PDFF = |F|/|W+F| is ill-conditioned where random nets make the fitted
    # water and fat cancel: compared where |W+F| > 0.2
    w_f = cpu_maps[:, 0] + cpu_maps[:, 1]
    stable = np.abs(w_f[..., 0] + 1j * w_f[..., 1]) > 0.2
    pdff_err = float(np.abs(pd_dev - pd_cpu)[stable].max())
    tf32_err = float(np.abs(maps[:batch] - cpu_maps).max())
    return dict(launches=launches, slices_per_s=slices_per_s,
                ms_per_slice=1e3 / slices_per_s, wall_s=wall,
                cpu_chunk_s=cpu_s, maps_max_abs_err_vs_cpu=maps_err,
                pdff_max_abs_err_vs_cpu=pdff_err,
                pdff_compared_share=float(stable.mean()),
                serving_tf32_maps_max_abs_diff_vs_cpu=tf32_err)


MAG_PARITY_CONFIGS = {
    "defaults": {},
    # the magnitude cycle loss and every regularizer: a real gradient
    # through the magnitude fit (the defaults reach it only through
    # 0-weighted terms)
    "unsupervised": dict(training_mode="unsupervised", main_loss="MAE",
                         R2_TV_weight=1e-3, A_demod_TV_weight=1e-3,
                         LS_NZ_weight=1e-2, LS_cond_weight=1e-2),
}


class _Float32Out:
    """A net run in float64 whose output is cast back to float32, so that
    the loss and the physics around it stay float32 (the float64 witness
    of `mag_step_parity` and the others). Floating tensors among the
    arguments go to the net's dtype; tensors in the output (alone, in a
    posterior, a tuple or a list) come back float32; other attributes are
    the net's."""

    def __init__(self, net):
        self.net = net

    def __getattr__(self, name):
        if name == "net":  # not set yet (copying)
            raise AttributeError(name)
        return getattr(self.net, name)

    def __call__(self, *args, **kwargs):
        import torch
        dtype = next(self.net.parameters()).dtype

        def arg(a):
            return a.to(dtype) if isinstance(a, torch.Tensor) \
                and a.is_floating_point() else a

        return self._f32(self.net(*map(arg, args),
                                  **{k: arg(v) for k, v in kwargs.items()}))

    @classmethod
    def _f32(cls, out):
        import dataclasses

        import torch
        if dataclasses.is_dataclass(out):  # a posterior (Normal, Rician)
            return dataclasses.replace(out, **{
                f.name: getattr(out, f.name).float()
                for f in dataclasses.fields(out)
                if isinstance(getattr(out, f.name), torch.Tensor)})
        if isinstance(out, (tuple, list)):
            return type(out)(cls._f32(o) for o in out)
        return out.float() if isinstance(out, torch.Tensor) \
            and out.is_floating_point() else out


def mag_step_parity(dev, size: int, batch: int, f: int) -> dict:
    """For each of `MAG_PARITY_CONFIGS`, one magnitude step's loss, metrics
    and gradients on `dev` and on the CPU from the same weights, maps and
    TE train (TF32 off on the card), and the card step with the plain
    ConvLSTM. The ground-truth maps carry N(0, 1e-3²) noise, so the net's
    input |A| has no exactly zero background (PERF.md §7). Each TEEncoder's
    Dense bias is spread over [0, 1], as the CPU parity tests do: with the
    zero-bias init every style vector is nearly constant, and AdaIN's √var
    of it amplifies float32 rounding in the TEEncoders' gradients.

    Witnesses, as `teaug_step_parity` has them: both f32 steps against the
    CPU step with the net in float64 (the physics and the loss stay
    float32), and the first module (in the backward's order) where the
    card's gradient leaves the CPU's by over 1e-2 of its scale. The same
    steps at Flax's zero-bias init (`zero_bias_init`) are reported beside
    the gated ones and not gated, with what sets their distance from
    float64: the card step with the plain ConvLSTM, and with the plain
    ConvLSTM's output perturbed by 1e-7 of its scale (four seeds), against
    float64; and how many ReLU inputs (norm outputs) lie on the other side
    of 0 in the card step with the kernels than with the plain ConvLSTM."""
    import copy

    import numpy as np
    import torch
    from ideal_gan_tpu_torch.cli.common import synthetic_dataset
    from ideal_gan_tpu_torch.train import mag

    cpu = torch.device("cpu")
    _, maps, te = synthetic_dataset(batch, h=size, w=size, ne=NE, seed=1)
    B = torch.from_numpy(maps + 1e-3 * np.random.default_rng(2).normal(
        size=maps.shape).astype(np.float32))
    te = torch.from_numpy(te)

    def steps(cfg, model, witness=False) -> dict:
        def run(where, plain=False, dtype=torch.float32, trace=False,
                noise=None):
            net = copy.deepcopy(model).to(device=where, dtype=dtype)
            traced = _trace(net) if trace else None
            call = net if dtype == torch.float32 else _Float32Out(net)
            with plain_convlstm(noise) if plain or noise \
                    else contextlib.nullcontext():
                loss, metrics = mag.make_loss_fn(cfg, call)(B.to(where),
                                                            te.to(where))
                loss.backward()
            if traced:
                for h in traced[3]:
                    h.remove()
            return dict(loss=float(loss.detach()), grads=_grads(net),
                        metrics={k: float(v.detach())
                                 for k, v in metrics.items()},
                        trace=traced[:3] if traced else None)

        card, ref = run(dev, trace=True), run(cpu, trace=True)
        ref64 = run(cpu, dtype=torch.float64)
        res = _compare(card, ref)
        res["metrics"], res["metrics_ref"] = card["metrics"], ref["metrics"]
        res["metrics_rel_diff"] = {k: _rel_diff(v, ref["metrics"][k])
                                   for k, v in card["metrics"].items()}
        plain = run(dev, plain=True, trace=witness)
        res["plain_convlstm_on_card_vs_cpu"] = _compare(plain,
                                                        ref)["grad_max_rel"]
        res["vs_cpu_float64"] = {
            "card": _compare(card, ref64)["grad_max_rel"],
            "cpu": _compare(ref, ref64)["grad_max_rel"]}
        grads, grads_ref, order_ref = card["trace"][1], *ref["trace"][1:]
        res["first_gradient_over_1e_2"] = next(
            (k for k in order_ref if _rel(grads[k], grads_ref[k]) > 1e-2),
            None)
        if witness:
            res["vs_cpu_float64"]["card_plain_convlstm"] = _compare(
                plain, ref64)["grad_max_rel"]
            res["vs_cpu_float64"]["card_plain_convlstm_perturbed_1e_7"] = [
                _compare(run(dev, noise=(1e-7, seed)), ref64)["grad_max_rel"]
                for seed in range(4)]
            outs, outs_plain = card["trace"][0], plain["trace"][0]
            norms = [n for n in outs_plain if n.endswith((".norm1", ".norm2"))]
            res["relu_flips_vs_plain_convlstm"] = {
                n: c for n in norms
                if (c := int(((outs[n] > 0) != (outs_plain[n] > 0)).sum()))}
            res["relu_inputs"] = sum(outs_plain[n].numel() for n in norms)
        return res

    out = {}
    for name, over in MAG_PARITY_CONFIGS.items():
        cfg = dict(mag.DEFAULTS, n_G_filters=f, **over)
        model = mag.build_model(cfg)
        model.init_params(torch.Generator().manual_seed(4))
        zero_bias = copy.deepcopy(model) if model.te else None
        with torch.no_grad():
            for enc in model.te or ():
                enc.dense.bias += torch.linspace(0.0, 1.0,
                                                 enc.dense.bias.numel())
        out[name] = steps(cfg, model)
        # without TEEncoders (unsupervised) the gated init is Flax's own
        out[name]["zero_bias_init"] = zero_bias and {
            k: v for k, v in steps(cfg, zero_bias, witness=True).items()
            if k not in ("metrics", "metrics_ref")}
    return out


def mag_phase(dev, out_dir: Path, size: int = SIZE, n: int = 16,
              batch: int = NB_SERVE, f: int = F_MAIN, parity_size: int = 96,
              parity_batch: int = 2, serve_compared: int = 2) -> dict:
    """The magnitude training CLI and one unsupervised step on the card,
    with the launch counters read around each; the card-vs-CPU steps; the
    Mag serving CLI with the counters read around it, and its first
    `serve_compared` slices on the card and on the CPU, compared."""
    import math

    import numpy as np
    import torch
    from ideal_gan_tpu_torch import physics
    from ideal_gan_tpu_torch.cli import infer, roi_analysis, train_mag
    from ideal_gan_tpu_torch.cli.common import load_cohorts
    from ideal_gan_tpu_torch.train import mag

    argv = ["--synthetic", str(n), "--data_size", str(size), "--batch_size",
            str(batch), "--epochs", "2", "--n_G_filters", str(f), "--seed",
            "0", "--device", str(dev), "--output_base", str(out_dir / "t")]
    result, wall, launches = counted(dev, lambda: train_mag.main(argv))
    state = result["state"]
    losses = [ep["G_loss"] for ep in result["epochs"]]
    no_grad = [n_ for n_, p in state.model.lstm.named_parameters()
               if p.grad is None or not bool(p.grad.abs().max() > 0)]
    if not all(math.isfinite(v) for v in losses) or no_grad:
        raise AssertionError(f"mag training: losses {result['epochs']}, "
                             f"ConvLSTM parameters without a gradient "
                             f"{no_grad}")
    last = result["epochs"][-1]
    step_ms = last["seconds"] / last["steps"] * 1e3

    # one unsupervised step (the cycle loss) on the cohort's first batch
    cfg_u = dict(mag.DEFAULTS, n_G_filters=f, training_mode="unsupervised")
    model_u = mag.build_model(cfg_u)
    step_u, tx_u = mag.make_train_step(cfg_u, model_u)
    state_u = mag.init_state(cfg_u, model_u, tx_u, torch.Generator().manual_seed(0), dev)
    _, maps, te = load_cohorts(dict(mag.DEFAULTS, synthetic=n,
                                    data_size=size))
    bt = (torch.from_numpy(maps[:batch]).to(dev),
          torch.from_numpy(te[:batch]).to(dev))
    step_u(state_u, bt)  # warm-up
    (_, metrics_u), unsup_s, launches_u = counted(
        dev, lambda: step_u(state_u, bt))
    unsup = dict(launches=launches_u, ms_per_step=unsup_s * 1e3,
                 metrics={k: float(v) for k, v in metrics_u.items()})
    if not all(math.isfinite(v) for v in unsup["metrics"].values()):
        raise AssertionError(f"unsupervised mag step not finite: {unsup}")

    set_tf32(False)
    parity = mag_step_parity(dev, parity_size, parity_batch, f)

    set_tf32(True)
    argv = ["--model_sel", "Mag", "--synthetic", str(n), "--data_size",
            str(size), "--infer_batch", str(batch), "--export", "npz",
            "--seed", "0", "--device", str(dev), "--output_base",
            str(out_dir / "s")]
    served, serve_wall, launches_s = counted(dev, lambda: infer.main(argv))
    if served.shape != (n, 3, size, size, 2) or not np.isfinite(served).all():
        raise AssertionError(f"Mag maps shape {served.shape} or not finite")
    with np.load(out_dir / "s" / "infer" / "maps_pred.npz") as npz:
        slices_per_s = float(npz["slices_per_s"])
    cfg = dict(infer.DEFAULTS, model_sel="Mag", seed=0, synthetic=n,
               data_size=size)
    acqs, _, te = load_cohorts(cfg)
    a, t = acqs[:serve_compared], te[:serve_compared]
    set_tf32(False)
    dev_maps, dev_var = roi_analysis._per_slice(
        roi_analysis.make_infer_run(cfg, a, dev), a, t, serve_compared, dev)
    cpu_maps, cpu_var = roi_analysis._per_slice(
        roi_analysis.make_infer_run(cfg, a, "cpu"), a, t, serve_compared,
        "cpu")
    # the CPU's LS coefficients mark where ρ's eigenvector is well-posed
    a_mag = np.sqrt(np.sum(np.square(a), -1, keepdims=True))
    ls = physics.cse_mag_fit(torch.from_numpy(a_mag),
                             torch.from_numpy(cpu_maps[:, 2:3, ..., 1:]),
                             torch.from_numpy(t)).ls_coeffs
    well = _mag_rho_well(ls)[:, None].expand(-1, 2, -1, -1, -1).numpy()
    d_rho = np.abs(dev_maps[:, :2, ..., :1] - cpu_maps[:, :2, ..., :1])
    serve = dict(launches=launches_s, chunks=-(-n // batch),
                 slices_per_s=slices_per_s, ms_per_slice=1e3 / slices_per_s,
                 wall_s=serve_wall, compared_slices=serve_compared,
                 r2_max_abs_err_vs_cpu=float(
                     np.abs(dev_maps[:, 2] - cpu_maps[:, 2]).max()),
                 rho_max_abs_err_vs_cpu=float(d_rho.max()),
                 rho_well_max_abs_err_vs_cpu=float(d_rho[well].max()),
                 rho_cancelling_share=float(1.0 - well.mean()),
                 rho_var_max_abs_err_vs_cpu=float(
                     np.abs(dev_var - cpu_var).max()))
    return dict(launches=launches, steps=state.step, wall_s=wall,
                epochs=result["epochs"], ms_per_step=step_ms,
                slices_per_s=batch * 1e3 / step_ms, unsupervised_step=unsup,
                parity=parity, parity_shape=dict(size=parity_size,
                                                  batch=parity_batch, F=f),
                serve=serve)


def check_mag(mag: dict) -> None:
    """The mag phase's gates: kernels launched on each path, card-vs-CPU
    steps (MODEL_PARITY.json's tolerances, as the other trainers) and the
    served maps against the CPU (the fit turns an R2* difference dR into a
    relative one of up to 2·te·r2_sc·dR ≈ 5·dR at the last echo; 5e-3 as
    the AI-DEAL maps)."""
    steps = mag["steps"]
    runs = {"train": (mag["launches"], steps),
            "unsupervised step": (mag["unsupervised_step"]["launches"], 1)}
    for what, (launches, k) in runs.items():
        if launches["ideal_mag_fit"] != k or launches["ideal_forward"] != k \
                or launches["convlstm_fwd"] < k \
                or launches["convlstm_bwd"] < k:
            raise AssertionError(f"mag {what} skipped kernels in {k} steps: "
                                 f"{launches}")
    served, chunks = mag["serve"]["launches"], mag["serve"]["chunks"]
    if served["ideal_mag_fit"] < chunks or served["convlstm_fwd"] < chunks:
        raise AssertionError(f"Mag serving skipped kernels: {served}")
    bad = _parity_failures(mag["parity"])
    if bad:
        raise AssertionError(f"card and CPU mag steps disagree (loss, "
                             f"gradients, metrics): {bad}")
    # R2*, the rank-1 ratio and ρ where its eigenvector is well-posed: where
    # the random net's R2* bends the LS b coefficient to ≈ 0 the closed
    # form's fat part cancels (_mag_rho_well)
    serve = mag["serve"]
    if max(serve["r2_max_abs_err_vs_cpu"], serve["rho_well_max_abs_err_vs_cpu"],
           serve["rho_var_max_abs_err_vs_cpu"]) > 5e-3:
        raise AssertionError(f"card and CPU Mag maps disagree: {serve}")


def vetnet_serve_phase(dev, out_dir: Path, size: int = SIZE, n: int = 16,
                       batch: int = NB_SERVE, f: int = F_TEAUG,
                       compared: int = 2) -> dict:
    """VET-Net trained on the card for one epoch by the TE-augmentation CLI,
    then served from its experiment directory by the serving CLI with the
    launch counters read around the serving call; the step of the
    checkpoint it restored; its first `compared` slices served again on
    the card and on the CPU (TF32 off), and, as witnesses, on the card with
    the plain ConvLSTM and on the CPU with the net in float64 (the fit
    stays float32); the phase-constrained fit of the card's (φ, R2*) on
    the CPU, against the card's fit of them; and the served maps' distance
    from those of the seeded initial weights at the experiment's settings
    (its `settings.yml` without its checkpoints), which shows the
    checkpoint was read."""
    import shutil

    import numpy as np
    import torch
    from ideal_gan_tpu_torch import physics
    from ideal_gan_tpu_torch.cli import infer, roi_analysis, train_teaug
    from ideal_gan_tpu_torch.cli.common import load_cohorts
    from ideal_gan_tpu_torch.train import teaug

    argv = ["--synthetic", str(n), "--data_size", str(size), "--batch_size",
            str(batch), "--epochs", "1", "--n_G_filters", str(f), "--seed",
            "0", "--device", str(dev), "--output_base", str(out_dir / "t")]
    t0 = time.perf_counter()
    steps_trained = train_teaug.main(argv)["state"].step
    train_s = time.perf_counter() - t0
    exp = out_dir / "t" / teaug.DEFAULTS["dataset"]
    argv = ["--model_sel", "VET-Net", "--experiment_dir", str(exp),
            "--synthetic", str(n), "--data_size", str(size), "--infer_batch",
            str(batch), "--export", "npz", "--seed", "0", "--device",
            str(dev), "--output_base", str(out_dir / "s")]
    maps, wall, launches = counted(dev, lambda: infer.main(argv))
    if maps.shape != (n, 3, size, size, 2) or not np.isfinite(maps).all():
        raise AssertionError(f"VET-Net maps shape {maps.shape} or not finite")
    with np.load(out_dir / "s" / "infer" / "maps_pred.npz") as npz:
        slices_per_s = float(npz["slices_per_s"])

    cfg = dict(infer.DEFAULTS, experiment_dir=str(exp), seed=0, synthetic=n,
               data_size=size)
    step = roi_analysis.restore_checkpoint(cfg)["step"]
    acqs, _, te = load_cohorts(cfg)
    a, t = acqs[:compared], te[:compared]

    def serve(c, where):
        return roi_analysis._per_slice(roi_analysis.make_infer_run(c, a,
                                                                   where),
                                       a, t, compared, where)[0]

    set_tf32(False)
    dev_maps = serve(cfg, dev)
    t_cpu = time.perf_counter()
    cpu_maps = serve(cfg, "cpu")
    cpu_s = time.perf_counter() - t_cpu
    with plain_convlstm():
        plain_maps = serve(cfg, dev)
    net64 = roi_analysis.load_vetnet(cfg, "cpu")[0].double()
    with torch.inference_mode():
        f64_maps = roi_analysis.vetnet_maps(
            net64, torch.from_numpy(a), torch.from_numpy(t),
            cfg["field"])[0].numpy()
        # the fit alone on the CPU, from the card's (φ, R2*)
        cpu_fit = physics.fit_rho(
            torch.from_numpy(a), torch.from_numpy(dev_maps[:, 2:3]),
            torch.from_numpy(t), field=cfg["field"],
            phase_constraint=True).numpy()
    seeded = out_dir / "seeded"
    seeded.mkdir()
    shutil.copy(exp / "settings.yml", seeded)
    seeded_maps = serve(dict(cfg, experiment_dir=str(seeded)), dev)

    # PDFF = |F|/|W+F| is ill-conditioned where the fitted water and fat
    # cancel: compared where |W+F| > 0.2, as the AI-DEAL serving phase.
    # The shared phase is ill-conditioned where its sum is ≈ 0: ρ there is
    # reported apart
    def masks(maps):
        w_f = maps[:, 0] + maps[:, 1]
        sums = phase_sum(a, maps[:, 2:3], t, cfg["field"])
        return (np.abs(w_f[..., 0] + 1j * w_f[..., 1]) > 0.2,
                sums > 1e-3 * sums.max())

    def dist(x, y, stable, phase_ok):
        d_rho = np.abs(x[:, :2] - y[:, :2]).max(axis=(1, 4))
        d_pdff = np.abs(infer.maps_to_display(x)[0]
                        - infer.maps_to_display(y)[0])
        return dict(pm=float(np.abs(x[:, 2] - y[:, 2]).max()),
                    rho=float(d_rho.max()),
                    rho_phase_well_posed=float(d_rho[phase_ok].max()),
                    pdff=float(d_pdff[stable].max()),
                    pdff_phase_well_posed=float(
                        d_pdff[stable & phase_ok].max()))

    stable, phase_ok = masks(f64_maps)
    fit_only = dist(dev_maps, np.concatenate([cpu_fit, dev_maps[:, 2:3]], 1),
                    *masks(dev_maps))
    return dict(launches=launches, chunks=-(-n // batch),
                steps_trained=steps_trained, checkpoint_step=step,
                train_s=train_s, slices_per_s=slices_per_s,
                ms_per_slice=1e3 / slices_per_s, wall_s=wall,
                compared_slices=compared, cpu_s=cpu_s,
                pdff_compared_share=float(stable.mean()),
                phase_well_posed_share=float(phase_ok.mean()),
                vs_cpu=dist(dev_maps, cpu_maps, stable, phase_ok),
                fit_on_card_maps_vs_cpu=fit_only,
                vs_cpu_float64={
                    name: dist(m, f64_maps, stable, phase_ok)
                    for name, m in (("card", dev_maps), ("cpu", cpu_maps),
                                    ("card_plain_convlstm", plain_maps))},
                maps_max_abs_diff_vs_seeded_init=float(
                    np.abs(dev_maps - seeded_maps).max()),
                serving_tf32_maps_max_abs_diff_vs_cpu=float(
                    np.abs(maps[:compared] - cpu_maps).max()))


def phase_sum(a, pm, te, field: float = 1.5):
    """|Σ_s ρ_s·(H⁺ρ)_s| per voxel (nb, H, W), the sum whose angle the
    phase-constrained fit takes as twice the shared phase, from the
    unconstrained LS ρ of the acquisitions `a` at the maps `pm`. Where it
    is ≈ 0 the phase is ill-conditioned, and any two float32 versions of
    the fit can differ by up to |ρ| there."""
    import torch
    from ideal_gan_tpu_torch import physics
    from ideal_gan_tpu_torch.physics import matrix as mx

    a, pm, te = (torch.as_tensor(x) for x in (a, pm, te))
    rho = physics.fit_rho(a, pm, te, field=field)
    c = torch.complex(rho[..., 0], rho[..., 1]).flatten(2)
    m = mx.model_matrix(te, field)
    h = mx.phase_constraint_matrix(m, mx.pinv_normal(m))
    return (c * (h @ c)).sum(1).abs().reshape(rho.shape[:1]
                                              + rho.shape[2:4]).numpy()


def check_vetnet_serve(vet: dict) -> None:
    """The vetnet_serve phase's gates: the ConvLSTM forward launched once
    an echo of every served chunk (the warm-up chunk included); the
    checkpoint of the training run's last step restored and read; the
    net's (φ, R2*) on the card against the CPU at the AI-DEAL serving gate
    (5e-3); and the plain phase-constrained fit on the card against the
    CPU on the card's (φ, R2*): ρ where the shared phase is well posed,
    PDFF there and where |W+F| > 0.2, each ≤ 5e-3.

    The served ρ and PDFF are reported, not gated: the fit turns the
    net's (φ, R2*) difference into up to ~15–22× that in ρ, and PDFF ~5×
    more, so float32 residue alone takes them past 5e-3 (the CPU's own
    float32 run lies that far from its float64 witness; PERF.md §6)."""
    need = (vet["chunks"] + 1) * NE
    if vet["launches"]["convlstm_fwd"] < need:
        raise AssertionError(f"VET-Net serving skipped the ConvLSTM forward "
                             f"kernel ({need} launches needed): "
                             f"{vet['launches']}")
    if vet["checkpoint_step"] != vet["steps_trained"] \
            or not vet["maps_max_abs_diff_vs_seeded_init"] > 0:
        raise AssertionError(f"VET-Net serving did not read the trained "
                             f"checkpoint: step {vet['checkpoint_step']}, "
                             f"distance from the seeded init "
                             f"{vet['maps_max_abs_diff_vs_seeded_init']}")
    fit = vet["fit_on_card_maps_vs_cpu"]
    if vet["vs_cpu"]["pm"] > 5e-3 or fit["rho_phase_well_posed"] > 5e-3 \
            or fit["pdff_phase_well_posed"] > 5e-3:
        raise AssertionError(f"card and CPU VET-Net maps disagree: {vet}")


def counted(dev, fn):
    """`fn()` with every launch counter set to 0 just before and read just
    after: (its result, its seconds to a synchronisation, the launches)."""
    import torch
    from ideal_gan_tpu_torch import ops
    for k in ops.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    result = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return result, time.perf_counter() - t0, {k.name: k.launches
                                              for k in ops.KERNELS}


def counted_peak(dev, fn):
    """`counted(dev, fn)` and the peak device memory of the call in GB
    (None on the CPU)."""
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    result, wall, launches = counted(dev, fn)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else None
    return result, wall, launches, peak


def steady_step(dev, fn, batch: int, iters: int = 3) -> dict:
    """A trainer's step `fn` after the CLI's run (one more warm-up, then
    `iters` steps timed with CUDA events): its ms, slices/s and the peak
    device memory of those steps (None on the CPU). The CLI's own epoch
    of two steps includes the first step's set-up."""
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    ms = time_ms(fn, dev, iters=iters, warmup=1)
    return dict(ms_per_step=ms, slices_per_s=batch * 1e3 / ms,
                peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9
                if dev.type == "cuda" else None)


def _finite_losses(epochs) -> bool:
    import math
    return bool(epochs) and all(
        math.isfinite(v) for ep in epochs for k, v in ep.items()
        if k.endswith("loss") and isinstance(v, float))


def _no_gradient(net, prefixes) -> list:
    """The trainable parameters of `net` under `prefixes` without a
    non-zero gradient."""
    return [n for n, p in net.named_parameters()
            if p.requires_grad and n.startswith(prefixes)
            and (p.grad is None or not bool(p.grad.abs().max() > 0))]


def _step_run(make_loss, nets, args, where, dtype=None):
    """One loss's value, metrics and gradient leaves on `where` from copies
    of `nets` (which `make_loss` takes in order) and of `args`: every
    parameter that gets a gradient, as "<i>.<name>" of the i-th net (a net
    the loss runs without gradient has none), and every argument that
    requires one, as "arg<i>". With `dtype` float64 the nets run in
    float64 and their outputs are cast back to float32 (`_Float32Out`), the
    physics and the loss staying float32."""
    import copy

    nets = [copy.deepcopy(m).to(where) for m in nets]
    calls = nets
    if dtype is not None:
        nets = [n.to(dtype) for n in nets]
        calls = [_Float32Out(n) for n in nets]
    args = [a.detach().to(where).requires_grad_() if a.requires_grad
            else a.to(where) for a in args]
    loss, metrics = make_loss(*calls)(*args)
    loss.backward()
    grads = {f"{i}.{k}": v for i, n in enumerate(nets)
             for k, v in _grads(n).items()}
    grads.update({f"arg{i}": a.grad.detach().cpu()
                  for i, a in enumerate(args) if a.requires_grad})
    return dict(loss=float(loss.detach()), grads=grads,
                metrics={k: float(v.detach()) for k, v in metrics.items()})


# the step gates' plain tolerances (MODEL_PARITY.json's): the loss and
# each metric relative to the CPU's, every gradient leaf of the global
# scale (`_parity_failures`; `_gan_parity_failures` takes the loss and
# metrics relative to max(|CPU|, 1), `_loss_gap`)
STEP_LOSS_TOL = 2e-5
STEP_GRAD_TOL = 2e-2


def _loss_gap(x: float, ref: float) -> float:
    return abs(x - ref) / max(abs(ref), 1.0)


def _parity(make_loss, nets, args, dev, lazy_witness: bool = False) -> dict:
    """`_step_run` on `dev` and on the CPU compared (`_parity_of`: loss,
    metrics, every gradient leaf), with both against the CPU's float64
    witness. With `lazy_witness` the witness runs only where the card is
    past the plain tolerances (STEP_LOSS_TOL of the loss and of each
    metric, STEP_GRAD_TOL of the gradients' scale), its fields None
    otherwise, where no gate reads them (`_parity_failures` never does,
    `_gan_parity_failures` only past the same tolerances)."""
    import torch
    cpu = torch.device("cpu")
    card = _step_run(make_loss, nets, args, dev)
    ref = _step_run(make_loss, nets, args, cpu)
    if lazy_witness:
        plain = _parity_of(card, ref, None)
        if plain["loss_rel_diff"] <= STEP_LOSS_TOL \
                and plain["grad_max_rel"] <= STEP_GRAD_TOL \
                and all(d <= STEP_LOSS_TOL
                        for d in plain["metrics_rel_diff"].values()):
            return plain
    return _parity_of(card, ref,
                      _step_run(make_loss, nets, args, cpu, torch.float64))


def _parity_of(card: dict, ref: dict, ref64: dict | None) -> dict:
    """`_parity`'s comparison of three `_step_run`s: the card's, the CPU's
    and the CPU's float64 witness (None: no witness, its fields None); the
    loss's and the metrics' relative distances from the witness too
    (`loss_vs_f64`, `metrics_vs_f64`)."""
    res = _compare(card, ref)
    res["metrics"], res["metrics_ref"] = card["metrics"], ref["metrics"]
    res["metrics_rel_diff"] = {k: _rel_diff(v, ref["metrics"][k])
                               for k, v in card["metrics"].items()}
    if ref64 is None:
        res.update(vs_cpu_float64=None, loss_f64=None, metrics_f64=None,
                   loss_vs_f64=None, metrics_vs_f64=None)
        return res
    res["vs_cpu_float64"] = {"card": _compare(card, ref64)["grad_max_rel"],
                             "cpu": _compare(ref, ref64)["grad_max_rel"]}
    res["loss_f64"], res["metrics_f64"] = ref64["loss"], ref64["metrics"]
    res["loss_vs_f64"] = {
        name: _rel_diff(run["loss"], ref64["loss"])
        for name, run in (("card", card), ("cpu", ref))}
    res["metrics_vs_f64"] = {
        name: {k: _rel_diff(v, ref64["metrics"][k])
               for k, v in run["metrics"].items()}
        for name, run in (("card", card), ("cpu", ref))}
    return res


def _parity_failures(parity: dict) -> dict:
    """The card-vs-CPU steps past MODEL_PARITY.json's tolerances: loss and
    metrics 2e-5 relative, every gradient leaf 2e-2 of the global scale."""
    return {name: (v["loss_rel_diff"], v["grad_max_rel"],
                   max(v["metrics_rel_diff"].values()))
            for name, v in parity.items()
            if v["loss_rel_diff"] > STEP_LOSS_TOL
            or v["grad_max_rel"] > STEP_GRAD_TOL
            or max(v["metrics_rel_diff"].values()) > STEP_LOSS_TOL}


# the sup phase's card-vs-CPU steps: the JAX DEFAULTS (multi-decod, out_vars
# WF), the 2D-Net's U-Net PM with resynthesis at another TE protocol, and
# MDWF-Net (multi-decod WF-PM)
SUP_PARITY_CONFIGS = {
    "multi-decod-WF": {},
    "U-Net-PM-resynthesis": dict(G_model="U-Net", out_vars="PM",
                                 TE1=0.0014, dTE=0.0022),
    "multi-decod-WF-PM": dict(out_vars="WF-PM"),
}


def sup_step_parity(dev, size: int, batch: int, f: int) -> dict:
    """For each of `SUP_PARITY_CONFIGS`, one supervised step's loss,
    metrics and gradients on `dev` and on the CPU from the same weights
    and batch (TF32 off on the card), with a float64 witness. The
    acquisitions and maps carry N(0, 1e-3²) noise, so that neither the
    nets' input nor the loss's `B != 0` masks have an exactly zero
    background (PERF.md §7)."""
    import numpy as np
    import torch
    from ideal_gan_tpu_torch.cli.common import synthetic_dataset
    from ideal_gan_tpu_torch.train import sup

    acqs, maps, te = synthetic_dataset(batch, h=size, w=size, ne=NE, seed=1)
    rng = np.random.default_rng(2)
    args = tuple(torch.from_numpy((x + 1e-3 * rng.normal(size=x.shape))
                                  .astype(np.float32)) for x in (acqs, maps))
    args += (torch.from_numpy(te),)
    out = {}
    for name, over in SUP_PARITY_CONFIGS.items():
        cfg = dict(sup.DEFAULTS, n_G_filters=f, **over)
        model = sup.build_model(cfg)
        model.init_params(torch.Generator().manual_seed(4))
        out[name] = _parity(lambda m: sup.make_loss_fn(cfg, m), (model,),
                            args, dev)
    return out


def sup_phase(dev, out_dir: Path, size: int = SIZE, n: int = 16,
              batch: int = NB_SERVE, f: int = F_TEAUG, parity_size: int = 96,
              parity_batch: int = 2, compared: int = 2) -> dict:
    """The supervised trainer's CLI twice (the JAX DEFAULTS; the U-Net in
    PM mode with resynthesis at another TE protocol), each with its steady
    step's time and peak memory (`steady_step`), and the 2D-Net serving
    CLI on the second run, each with the launch counters read around it;
    the card-vs-CPU steps; the 2D-Net's first `compared` slices served on
    the card and on the CPU (TF32 off) and, as a witness, on the CPU with
    the net in float64; the map fit of the card's (R2*, FM) on the CPU
    against the card's; and the served maps' distance from those of the
    seeded initial weights, which shows the checkpoint was read."""
    import shutil

    import numpy as np
    import torch
    from ideal_gan_tpu_torch import physics
    from ideal_gan_tpu_torch.cli import infer, roi_analysis, train_sup
    from ideal_gan_tpu_torch.cli.common import load_cohorts
    from ideal_gan_tpu_torch.train import sup

    base = ["--synthetic", str(n), "--data_size", str(size), "--batch_size",
            str(batch), "--epochs", "1", "--n_G_filters", str(f), "--seed",
            "0", "--device", str(dev)]
    runs = {}
    for name, over in (("defaults", {}),
                       ("U-Net-PM-resynthesis",
                        dict(G_model="U-Net", out_vars="PM", TE1=0.0014,
                             dTE=0.0022))):
        extra = [str(x) for k, v in over.items() for x in (f"--{k}", v)]
        result, wall, launches = counted(dev, lambda: train_sup.main(
            base + extra + ["--output_base", str(out_dir / name)]))
        if not _finite_losses(result["epochs"]):
            raise AssertionError(f"sup {name} losses not finite: "
                                 f"{result['epochs']}")
        state = result["state"]
        runs[name] = dict(launches=launches, steps=state.step, wall_s=wall,
                          epochs=result["epochs"])
        cfg = dict(sup.DEFAULTS, n_G_filters=f, **over)
        step_fn, _ = sup.make_train_step(cfg, state.model)
        acqs, maps, te = load_cohorts(dict(cfg, synthetic=n,
                                           data_size=size))
        bt = tuple(torch.from_numpy(x[:batch]).to(dev)
                   for x in (acqs, maps, te))
        gen = torch.Generator(device=dev).manual_seed(0)
        runs[name].update(steady_step(
            dev, lambda: step_fn(state, bt, gen), batch))

    exp = out_dir / "U-Net-PM-resynthesis" / sup.DEFAULTS["dataset"]
    argv = ["--model_sel", "2D-Net", "--experiment_dir", str(exp),
            "--synthetic", str(n), "--data_size", str(size), "--infer_batch",
            str(batch), "--export", "npz", "--seed", "0", "--device",
            str(dev), "--output_base", str(out_dir / "s")]
    maps, wall, launches = counted(dev, lambda: infer.main(argv))
    if maps.shape != (n, 3, size, size, 2) or not np.isfinite(maps).all():
        raise AssertionError(f"2D-Net maps shape {maps.shape} or not finite")
    with np.load(out_dir / "s" / "infer" / "maps_pred.npz") as npz:
        slices_per_s = float(npz["slices_per_s"])
    cfg = dict(infer.DEFAULTS, model_sel="2D-Net", experiment_dir=str(exp),
               seed=0, synthetic=n, data_size=size)
    step = roi_analysis.restore_checkpoint(cfg)["step"]
    acqs, _, te = load_cohorts(cfg)
    a, t = acqs[:compared], te[:compared]

    def serve(c, where):
        return roi_analysis._per_slice(roi_analysis.make_infer_run(c, a,
                                                                   where),
                                       a, t, compared, where)[0]

    set_tf32(False)
    dev_maps = serve(cfg, dev)
    cpu_maps = serve(cfg, "cpu")
    net64 = roi_analysis.load_sup_model(cfg, "cpu")[0].double()
    with torch.inference_mode():
        f64_maps = roi_analysis.twod_net_maps(
            _Float32Out(net64), torch.from_numpy(a), torch.from_numpy(t),
            cfg["field"])[0].numpy()
        # the fit alone on the CPU, from the card's (φ, R2*)
        cpu_fit = physics.fit_rho(torch.from_numpy(a),
                                  torch.from_numpy(dev_maps[:, 2:3]),
                                  torch.from_numpy(t),
                                  field=cfg["field"]).numpy()
    seeded = out_dir / "seeded"
    seeded.mkdir()
    shutil.copy(exp / "settings.yml", seeded)
    seeded_maps = serve(dict(cfg, experiment_dir=str(seeded)), dev)

    # PDFF = |F|/|W+F| where |W+F| > 0.2, as the other serving phases; ρ
    # relative to max(1, |ρ|): the fit multiplies the net's (φ, R2*)
    # residue by up to e^{R2*·r2_sc·te}
    w_f = f64_maps[:, 0] + f64_maps[:, 1]
    stable = np.abs(w_f[..., 0] + 1j * w_f[..., 1]) > 0.2

    def dist(x, y):
        d_rho = np.abs(x[:, :2] - y[:, :2]) / np.maximum(1.0,
                                                          np.abs(y[:, :2]))
        d_pdff = np.abs(infer.maps_to_display(x)[0]
                        - infer.maps_to_display(y)[0])
        return dict(pm=float(np.abs(x[:, 2] - y[:, 2]).max()),
                    rho_rel=float(d_rho.max()),
                    pdff=float(d_pdff[stable].max()))

    parity = sup_step_parity(dev, parity_size, parity_batch, f)
    serving = dict(
        launches=launches, chunks=-(-n // batch),
        steps_trained=runs["U-Net-PM-resynthesis"]["steps"],
        checkpoint_step=step, slices_per_s=slices_per_s,
        ms_per_slice=1e3 / slices_per_s, wall_s=wall,
        compared_slices=compared, pdff_compared_share=float(stable.mean()),
        vs_cpu=dist(dev_maps, cpu_maps),
        fit_on_card_maps_vs_cpu=dist(
            dev_maps, np.concatenate([cpu_fit, dev_maps[:, 2:3]], 1)),
        vs_cpu_float64={name: dist(m, f64_maps) for name, m in
                        (("card", dev_maps), ("cpu", cpu_maps))},
        maps_max_abs_diff_vs_seeded_init=float(
            np.abs(dev_maps - seeded_maps).max()),
        serving_tf32_maps_max_abs_diff_vs_cpu=float(
            np.abs(maps[:compared] - cpu_maps).max()))
    return dict(runs=runs, serving_2d_net=serving, parity=parity,
                parity_shape=dict(size=parity_size, batch=parity_batch, F=f))


def check_sup(s: dict) -> None:
    """The sup phase's gates: the synthesis and fit kernels once a step of
    the resynthesizing PM run, the fit once a served chunk (the warm-up
    chunk included); the checkpoint of the run's last step restored and
    read; the card-vs-CPU steps (`_parity_failures`); and the 2D-Net's
    (R2*, FM) card vs CPU and the fit on identical inputs at the serving
    gate, 5e-3 (ρ relative to max(1, |ρ|), PDFF where |W+F| > 0.2)."""
    pm = s["runs"]["U-Net-PM-resynthesis"]
    if pm["launches"]["ideal_forward"] != pm["steps"] \
            or pm["launches"]["ideal_fit"] != pm["steps"]:
        raise AssertionError(f"sup PM training skipped kernels in "
                             f"{pm['steps']} steps: {pm['launches']}")
    srv = s["serving_2d_net"]
    if srv["launches"]["ideal_fit"] != srv["chunks"] + 1:
        raise AssertionError(f"2D-Net serving skipped the fit kernel: "
                             f"{srv['launches']}")
    if srv["checkpoint_step"] != srv["steps_trained"] \
            or not srv["maps_max_abs_diff_vs_seeded_init"] > 0:
        raise AssertionError(f"2D-Net serving did not read the trained "
                             f"checkpoint: {srv}")
    bad = _parity_failures(s["parity"])
    if bad:
        raise AssertionError(f"card and CPU sup steps disagree (loss, "
                             f"gradients, metrics): {bad}")
    fit = srv["fit_on_card_maps_vs_cpu"]
    if srv["vs_cpu"]["pm"] > 5e-3 or fit["rho_rel"] > 5e-3 \
            or fit["pdff"] > 5e-3:
        raise AssertionError(f"card and CPU 2D-Net maps disagree: {srv}")


TEAUG_GENS = ("U-Net", "2U-Net", "MDWF-Net")


def teaug_gens_parity(dev, g_model: str, size: int, batch: int,
                      f: int) -> dict:
    """One step of the generator `g_model` on `dev` and on the CPU from the
    same weights, maps, TE train and noise (TF32 off on the card), with a
    float64 witness; for the 2U-Net also G_A2R2's step, and on the card one
    G_A2R2 optimizer step, which must change G_A2R2 and leave G_A2B as it
    was. The synthesized acquisitions carry N(0, 0.1²) noise, as in
    `teaug_step_parity`; each TEEncoder's Dense bias is spread over [0, 1]
    (`mag_step_parity`)."""
    import copy

    import numpy as np
    import torch
    from ideal_gan_tpu_torch import physics
    from ideal_gan_tpu_torch.cli.common import synthetic_dataset
    from ideal_gan_tpu_torch.train import teaug

    cfg = dict(teaug.DEFAULTS, G_model=g_model, n_G_filters=f)
    _, maps, _ = synthetic_dataset(batch, h=size, w=size, ne=NE, seed=1)
    te = physics.sample_te_train(torch.Generator().manual_seed(2), NE, batch)
    noise = torch.from_numpy(np.random.default_rng(3).normal(
        size=(batch, NE, size, size, 2)).astype(np.float32))
    args = (torch.from_numpy(maps), te, noise)
    nets = [teaug.build_model(cfg)]
    if g_model == "2U-Net":
        nets.append(teaug.build_r2_model(cfg))
    gen = torch.Generator().manual_seed(4)
    for net in nets:
        net.init_params(gen)
        with torch.no_grad():
            for m in net.modules():
                if isinstance(m, torch.nn.Linear) and m.bias is not None:
                    m.bias += torch.linspace(0.0, 1.0, m.bias.numel())
    out = {"generator": _parity(
        lambda m, *r2: teaug.make_loss_fn(cfg, m, *r2), nets, args, dev)}
    if g_model != "2U-Net":
        return out
    out["r2"] = _parity(lambda r2, m: teaug.make_r2_loss_fn(cfg, m, r2),
                        nets[::-1], args, dev)
    model, r2 = (copy.deepcopy(n).to(dev) for n in nets)
    _, tx = teaug.make_train_step(dict(cfg, epochs=1), model, r2)
    state = teaug.TEAugState(model, tx(list(model.parameters())),
                             r2_model=r2, opt_r2=tx(list(r2.parameters())))
    before = [{k: v.clone() for k, v in n.state_dict().items()}
              for n in (model, r2)]
    teaug.make_r2_train_step(cfg, model, r2, tx)(
        state, tuple(a.to(dev) for a in args[:2]),
        torch.Generator(device=dev).manual_seed(5))
    out["r2_step_changes"] = {
        name: sorted(k for k, v in net.state_dict().items()
                     if not torch.equal(v, old[k]))
        for name, net, old in (("G_A2B", model, before[0]),
                               ("G_A2R2", r2, before[1]))}
    return out


def teaug_gens_phase(dev, out_dir: Path, size: int = SIZE, n: int = 16,
                     batch: int = NB_SERVE, f: int = F_TEAUG,
                     parity_size: int = 96, parity_batch: int = 2) -> dict:
    """The TE-augmentation CLI with each of `TEAUG_GENS` for one epoch,
    with the launch counters read around each run, the trained nets'
    ConvLSTM and TE parameters' gradients, the steady step's time and
    peak memory (`steady_step`), and the card-vs-CPU steps."""
    import torch
    from ideal_gan_tpu_torch.cli import train_teaug
    from ideal_gan_tpu_torch.cli.common import load_cohorts
    from ideal_gan_tpu_torch.train import teaug

    out = {}
    for g in TEAUG_GENS:
        argv = ["--G_model", g, "--synthetic", str(n), "--data_size",
                str(size), "--batch_size", str(batch), "--epochs", "1",
                "--n_G_filters", str(f), "--seed", "0", "--device", str(dev),
                "--output_base", str(out_dir / g)]
        result, wall, launches = counted(dev, lambda: train_teaug.main(argv))
        if not _finite_losses(result["epochs"]):
            raise AssertionError(f"teaug {g} losses not finite: "
                                 f"{result['epochs']}")
        state = result["state"]
        # the ConvLSTM and TE conditioning of every net that was trained
        no_grad = _no_gradient(state.model, ("lstm.", "te.", "encoder.te"))
        if state.r2_model is not None:
            no_grad += ["G_A2R2 " + k for k in
                        _no_gradient(state.r2_model, ("lstm.", "te."))]
        if no_grad:
            raise AssertionError(f"teaug {g}: ConvLSTM / TE parameters "
                                 f"without a gradient: {no_grad}")
        out[g] = dict(launches=launches, steps=state.step, wall_s=wall,
                      epochs=result["epochs"])
        # the steady step (the 2U-Net: G_A2B's step and G_A2R2's)
        cfg = dict(teaug.DEFAULTS, G_model=g, n_G_filters=f)
        step_fn, tx = teaug.make_train_step(cfg, state.model, state.r2_model)
        steps = [step_fn] if state.r2_model is None else [
            step_fn, teaug.make_r2_train_step(cfg, state.model,
                                              state.r2_model, tx)]
        _, maps, _ = load_cohorts(dict(cfg, synthetic=n, data_size=size))
        gen = torch.Generator().manual_seed(0)
        bt = (torch.from_numpy(maps[:batch]).to(dev),
              teaug.sample_te(gen, cfg, batch).to(dev))
        noise_gen = torch.Generator(device=dev).manual_seed(0)
        out[g].update(steady_step(
            dev, lambda: [s(state, bt, noise_gen) for s in steps], batch))
        set_tf32(False)
        out[g]["parity"] = teaug_gens_parity(dev, g, parity_size,
                                             parity_batch, f)
        set_tf32(True)
    out["parity_shape"] = dict(size=parity_size, batch=parity_batch, F=f)
    return out


def check_teaug_gens(gens: dict) -> None:
    """The teaug_gens phase's gates: the synthesis kernel once a step (and
    once an R2* step for the 2U-Net), the ConvLSTM forward and backward
    and the fit at least once a step for the ME nets; the card-vs-CPU
    steps (`_parity_failures`); and G_A2R2's step changing G_A2R2 only."""
    for g in TEAUG_GENS:
        run = gens[g]
        k, launches = run["steps"], run["launches"]
        synth = 2 * k if g == "2U-Net" else k
        short = launches["ideal_forward"] != synth or (
            g != "MDWF-Net" and any(launches[name] < k for name in (
                "convlstm_fwd", "convlstm_bwd", "ideal_fit")))
        if short:
            raise AssertionError(f"teaug {g} skipped kernels in {k} steps: "
                                 f"{launches}")
        bad = _parity_failures({f"{g} {step}": v for step, v in
                                run["parity"].items() if step != "r2_step_changes"})
        if bad:
            raise AssertionError(f"card and CPU teaug steps disagree (loss, "
                                 f"gradients, metrics): {bad}")
    changes = gens["2U-Net"]["parity"]["r2_step_changes"]
    if changes["G_A2B"] or not changes["G_A2R2"]:
        raise AssertionError(f"the 2U-Net's R2* step: {changes}")


# the uq phase's card-vs-CPU steps: the FM step with both Bayesian heads
# (the heteroscedastic loss on the propagated variance), the R2 step, and
# the calibration step, at a calibration away from ones
UQ_CALIB = (1.0, 0.8, 1.3, 0.5, 1.1, 0.9)


def uq_step_parity(dev, size: int, batch: int, f: int) -> dict:
    """The UQ FM step, the R2 step and the calibration step on `dev` and on
    the CPU from the same weights and batch (TF32 off on the card), each
    with a float64 witness (the nets in float64; the physics, the
    propagated variance and the loss float32): loss, metrics and every
    gradient leaf (for the calibration step its one leaf, `calib`, as
    "arg0": the nets are frozen). The batch is the
    synthetic cohort plus N(0, 1e-3²) noise, as `step_parity`'s."""
    import numpy as np
    import torch
    from ideal_gan_tpu_torch.cli.common import synthetic_dataset
    from ideal_gan_tpu_torch.train import unsup

    cfg = dict(unsup.DEFAULTS, n_G_filters=f, out_vars="PM", UQ=True,
               UQ_R2s=True)
    clean, _, te = synthetic_dataset(batch, h=size, w=size, ne=NE, seed=1)
    A = torch.from_numpy(clean + 1e-3 * np.random.default_rng(2).normal(
        size=clean.shape).astype(np.float32))
    te = torch.from_numpy(te)
    off = torch.zeros(())
    g_fm, g_r2 = unsup.build_models(cfg)
    gen = torch.Generator().manual_seed(3)
    g_fm.init_params(gen)
    g_r2.init_params(gen)
    calib = torch.tensor(UQ_CALIB)
    return {
        "fm": _parity(lambda m, r2: unsup.make_loss_fn(cfg, m, r2),
                      (g_fm, g_r2), (off, A, te, calib), dev),
        "r2": _parity(lambda r2, m: unsup.make_r2_loss_fn(cfg, m, r2),
                      (g_r2, g_fm), (off, A, te), dev),
        "calib": _parity(lambda m, r2: unsup.make_calib_loss_fn(cfg, m, r2),
                         (g_fm, g_r2),
                         (calib.clone().requires_grad_(), off, A, te), dev)}


def _heads(g_fm, g_r2, fm_offset, a):
    """`roi_analysis.aideal_heads` as numpy (φ mean, φ var, R2* mean, R2*
    var), each (nb, 1, H, W, 1)."""
    import torch
    from ideal_gan_tpu_torch.cli import roi_analysis
    with torch.inference_mode():
        (fm, fm_var), (r2, r2_var) = roi_analysis.aideal_heads(
            g_fm, g_r2, fm_offset, a)
    return [x.cpu().numpy() for x in (fm, fm_var, r2, r2_var)]


def _gls(heads, a, t, where, field: float):
    """`physics.pdff_uncertainty` (ρ, rho_var) on `where` from the heads'
    numpy outputs, as numpy."""
    import torch
    from ideal_gan_tpu_torch import physics
    fm, fm_var, r2, r2_var = (torch.from_numpy(x[:, 0, ..., 0]).to(where)
                              for x in heads)
    rho, rho_var = physics.pdff_uncertainty(
        torch.from_numpy(a).to(where), physics.Posterior(fm, fm_var),
        physics.Posterior(r2, r2_var), torch.from_numpy(t).to(where),
        field=field)
    return rho.cpu().numpy(), rho_var.cpu().numpy()


def _scaled(x, ref) -> float:
    """`_rel` of two numpy arrays."""
    import torch
    return _rel(torch.from_numpy(x), torch.from_numpy(ref))


def uq_phase(dev, out_dir: Path, size: int = SIZE, n: int = 24,
             batch: int = NB_SERVE, f: int = F_MAIN, parity_size: int = 96,
             parity_batch: int = 2, compared: int = 2) -> dict:
    """AI-DEAL's uncertainty path: the training CLI with `--out_vars PM --UQ
    1 --UQ_R2s 1 --UQ_calib 1` for one epoch (its calibration split, its
    calibration stage and the held-out NLL it prints), with the launch
    counters read around it; one more UQ step pair and one calibration
    step, each counted alone and then timed (`steady_step`); the serving
    CLI on that run with `--map PDFF-var` and with `--map PDFF`, each
    counted; the card-vs-CPU steps (`uq_step_parity`); and PDFF-var
    serving held stage by stage on the first `compared` slices: the heads'
    mean and variance card vs CPU, then `pdff_uncertainty` on identical
    inputs (the card's heads) on the card and on the CPU, beside the
    spread of two CPU evaluations whose inputs differ by float32's
    rounding (1 ulp)."""
    import numpy as np
    import torch
    from ideal_gan_tpu_torch.cli import infer, roi_analysis, train_unsup
    from ideal_gan_tpu_torch.cli.common import load_cohorts
    from ideal_gan_tpu_torch.train import unsup

    flags = dict(out_vars="PM", UQ=1, UQ_R2s=1, UQ_calib=1)
    argv = ["--synthetic", str(n), "--data_size", str(size), "--batch_size",
            str(batch), "--epochs", "1", "--n_G_filters", str(f), "--seed",
            "0", "--device", str(dev), "--output_base", str(out_dir / "t")]
    argv += [str(x) for k, v in flags.items() for x in (f"--{k}", v)]
    result, wall, launches = counted(dev, lambda: train_unsup.main(argv))
    if not _finite_losses(result["epochs"]):
        raise AssertionError(f"uq losses not finite: {result['epochs']}")
    state = result["state"]
    steps_trained = state.step
    no_grad = [f"{net}.{k}" for net in ("g_fm", "g_r2")
               for k in _no_gradient(getattr(state, net), ("lstm.",))]
    cfg = dict(unsup.DEFAULTS, n_G_filters=f, out_vars="PM", UQ=True,
               UQ_R2s=True, UQ_calib=True)
    acqs, _, te = load_cohorts(dict(cfg, synthetic=n, data_size=size))
    bt = (torch.from_numpy(acqs[:batch]).to(dev),
          torch.from_numpy(te[:batch]).to(dev))
    step_fn, tx = unsup.make_train_step(cfg, state.g_fm, state.g_r2)
    r2_fn = unsup.make_r2_train_step(cfg, state.g_fm, state.g_r2, tx)
    calib_fn = unsup.make_calib_train_step(cfg, state.g_fm, state.g_r2)

    def pair():
        step_fn(state, bt)
        r2_fn(state, bt)

    paths = {}
    for name, fn in (("uq_train", pair),
                     ("uq_calib", lambda: calib_fn(state, bt))):
        _, _, counts = counted(dev, fn)
        paths[name] = dict(launches=counts, **steady_step(dev, fn, batch))
    exp = out_dir / "t" / unsup.DEFAULTS["dataset"]
    for name, map_name in (("aideal_uq_serving_pdff_var", "PDFF-var"),
                           ("aideal_uq_serving_pdff", "PDFF")):
        argv = ["--model_sel", "AI-DEAL", "--experiment_dir", str(exp),
                "--map", map_name, "--synthetic", str(n), "--data_size",
                str(size), "--infer_batch", str(batch), "--export", "npz",
                "--seed", "0", "--device", str(dev), "--output_base",
                str(out_dir / name)]
        maps, wall_s, counts = counted(dev, lambda: infer.main(argv))
        if maps.shape != (n, 3, size, size, 2) \
                or not np.isfinite(maps).all():
            raise AssertionError(f"{name} maps {maps.shape} not finite")
        with np.load(out_dir / name / "infer" / "maps_pred.npz") as npz:
            slices_per_s = float(npz["slices_per_s"])
        paths[name] = dict(launches=counts, chunks=-(-n // batch),
                           slices_per_s=slices_per_s,
                           ms_per_slice=1e3 / slices_per_s, wall_s=wall_s)

    scfg = dict(infer.DEFAULTS, model_sel="AI-DEAL", experiment_dir=str(exp),
                map="PDFF-var", seed=0, synthetic=n, data_size=size)
    step = roi_analysis.restore_checkpoint(scfg)["step"]
    a, t = acqs[:compared], te[:compared]
    set_tf32(False)
    heads = {}
    for where in (dev, "cpu"):
        g_fm, g_r2, off = roi_analysis.load_models(scfg, where)
        heads[str(where)] = _heads(g_fm, g_r2, off,
                                   torch.from_numpy(a).to(where))
    card, cpu = heads[str(dev)], heads["cpu"]
    rho, var = _gls(card, a, t, dev, scfg["field"])
    rho_cpu, var_cpu = _gls(card, a, t, "cpu", scfg["field"])
    ulp = [np.nextafter(x, np.inf).astype(np.float32) for x in card]
    rho_ulp, var_ulp = _gls(ulp, np.nextafter(a, np.inf).astype(np.float32),
                            t, "cpu", scfg["field"])
    serving = dict(
        checkpoint_step=step, steps_trained=steps_trained,
        compared_slices=compared,
        heads_vs_cpu={k: float(np.abs(x - y).max()) for k, x, y in zip(
            ("fm", "fm_var", "r2", "r2_var"), card, cpu)},
        gls_on_card_heads_vs_cpu=dict(rho=_scaled(rho, rho_cpu),
                                      rho_var=_scaled(var, var_cpu)),
        gls_cpu_one_ulp_spread=dict(rho=_scaled(rho_ulp, rho_cpu),
                                    rho_var=_scaled(var_ulp, var_cpu)),
        pdff_var_finite=bool(np.isfinite(
            roi_analysis.pdff_variance_map(
                np.concatenate([rho, np.concatenate(card[::2], -1)], 1),
                var)).all()))
    parity = uq_step_parity(dev, parity_size, parity_batch, f)
    set_tf32(True)
    return dict(launches=launches, wall_s=wall, epochs=result["epochs"],
                steps=steps_trained, calibration=result.get("calibration"),
                no_gradient=no_grad, paths=paths, serving=serving,
                parity=parity,
                parity_shape=dict(size=parity_size, batch=parity_batch, F=f))


def check_uq(uq: dict) -> None:
    """The uq phase's gates: the cycle, ConvLSTM forward and backward
    kernels on the training CLI and on a step pair, the cycle and ConvLSTM
    forward on a calibration step (no backward: the nets are frozen), the
    fit kernel once a chunk of `--map PDFF` serving (the warm-up chunk
    included) and none under `--map PDFF-var`, the ConvLSTM forward on
    both; the calibration stage ran and every ConvLSTM parameter has a
    gradient; the card-vs-CPU steps (`_parity_failures`); PDFF-var serving
    per stage: the heads card vs CPU ≤ 5e-3, and `pdff_uncertainty` on
    identical inputs card vs CPU ≤ 1e-3 of each output's scale (float32's
    6e-8 relative rounding times the per-voxel 2×2 GLS's conditioning,
    which the 1-ulp spread shows)."""
    p = uq["paths"]
    need = {"uq_train": ("ideal_cycle", "convlstm_fwd", "convlstm_bwd"),
            "uq_calib": ("ideal_cycle", "convlstm_fwd"),
            "aideal_uq_serving_pdff": ("ideal_fit", "convlstm_fwd"),
            "aideal_uq_serving_pdff_var": ("convlstm_fwd",)}
    short = {k: p[k]["launches"] for k, names in need.items()
             if any(p[k]["launches"][x] < 1 for x in names)}
    short.update({"cli": uq["launches"]} if any(
        uq["launches"][x] < 1 for x in need["uq_train"]) else {})
    if short or p["uq_calib"]["launches"]["convlstm_bwd"] \
            or p["aideal_uq_serving_pdff_var"]["launches"]["ideal_fit"]:
        raise AssertionError(f"uq paths skipped kernels: {short or p}")
    srv = p["aideal_uq_serving_pdff"]
    if srv["launches"]["ideal_fit"] != srv["chunks"] + 1:
        raise AssertionError(f"PDFF serving skipped the fit: {srv}")
    if not uq["calibration"] or uq["no_gradient"]:
        raise AssertionError(f"uq calibration {uq['calibration']}, "
                             f"no gradient {uq['no_gradient']}")
    if uq["serving"]["checkpoint_step"] != uq["steps"]:
        raise AssertionError(f"serving did not restore the calibrated "
                             f"checkpoint: {uq['serving']}")
    bad = _parity_failures(uq["parity"])
    if bad:
        raise AssertionError(f"card and CPU UQ steps disagree (loss, "
                             f"gradients, metrics): {bad}")
    srv = uq["serving"]
    if max(srv["heads_vs_cpu"].values()) > 5e-3 \
            or max(srv["gls_on_card_heads_vs_cpu"].values()) > 1e-3 \
            or not srv["pdff_var_finite"]:
        raise AssertionError(f"card and CPU PDFF-var serving disagree: "
                             f"{srv}")


def single_step_parity(dev, size: int, batch: int, f: int) -> dict:
    """One single-subject step at the JAX `DEFAULTS` (bipolar, MSE) on
    `dev` and on the CPU from the same weights and batch (TF32 off on the
    card), with a float64 witness: loss, metrics and every gradient leaf of
    both nets. The echoes and maps carry N(0, 1e-3²) noise, so neither the
    nets' input nor the loss's masks have an exactly zero background."""
    import numpy as np
    import torch
    from ideal_gan_tpu_torch.cli.common import synthetic_dataset
    from ideal_gan_tpu_torch.train import single

    cfg = dict(single.DEFAULTS, n_G_filters=f)
    acqs, maps, te = synthetic_dataset(batch, h=size, w=size, ne=NE, seed=1)
    rng = np.random.default_rng(2)
    args = tuple(torch.from_numpy((x + 1e-3 * rng.normal(size=x.shape))
                                  .astype(np.float32)) for x in (acqs, maps))
    g_mag, g_pha = single.build_models(cfg)
    gen = torch.Generator().manual_seed(4)
    g_mag.init_params(gen)
    g_pha.init_params(gen)
    return _parity(lambda m, p: single.make_loss_fn(cfg, m, p),
                   (g_mag, g_pha), args + (torch.from_numpy(te),), dev)


def single_phase(dev, out_dir: Path, size: int = SIZE, f: int = F_MAIN,
                 epochs: int = 4, parity_size: int = 96) -> dict:
    """The single-subject CLI at the JAX `DEFAULTS` (F=36, bipolar, the
    `data_idx`-th 3 slices of a 12-slice synthetic cohort) for `epochs`
    full-batch steps with the launch counters read around it; one more
    step counted alone, then timed (`steady_step`); every ConvLSTM
    parameter's gradient; the card-vs-CPU step at `parity_size`²
    (`single_step_parity`)."""
    import torch
    from ideal_gan_tpu_torch.cli import train_single
    from ideal_gan_tpu_torch.cli.common import load_cohorts
    from ideal_gan_tpu_torch.train import single

    argv = ["--synthetic", "12", "--data_size", str(size), "--epochs",
            str(epochs), "--epoch_ckpt", str(epochs // 2), "--n_G_filters",
            str(f), "--seed", "0", "--device", str(dev), "--output_base",
            str(out_dir)]
    result, wall, launches = counted(dev, lambda: train_single.main(argv))
    if not _finite_losses(result["epochs"]):
        raise AssertionError(f"single losses not finite: {result['epochs']}")
    state = result["state"]
    no_grad = [f"{net}.{k}" for net in ("g_mag", "g_pha")
               for k in _no_gradient(getattr(state, net), ("lstm.",))]
    cfg = dict(single.DEFAULTS, n_G_filters=f)
    i0 = 3 * cfg["data_idx"]
    data = load_cohorts(dict(cfg, synthetic=12, data_size=size))
    bt = tuple(torch.from_numpy(x[i0:i0 + 3]).to(dev) for x in data)
    step_fn, _ = single.make_train_step(cfg, state.g_mag, state.g_pha)
    _, _, step_launches = counted(dev, lambda: step_fn(state, bt))
    timed = steady_step(dev, lambda: step_fn(state, bt), 3)
    set_tf32(False)
    parity = single_step_parity(dev, parity_size, 3, f)
    set_tf32(True)
    return dict(launches=launches, steps=epochs, wall_s=wall,
                epochs=result["epochs"], no_gradient=no_grad,
                launches_per_step=step_launches, **timed, parity=parity,
                parity_shape=dict(size=parity_size, batch=3, F=f))


def check_single(s: dict) -> None:
    """The single phase's gates: both ConvLSTM kernels at least once a step
    of the CLI's run and in the step counted alone; finite losses and a
    gradient on every ConvLSTM parameter of both nets; the card-vs-CPU
    step (`_parity_failures`)."""
    k = s["steps"]
    if any(s["launches"][x] < k or s["launches_per_step"][x] < 1
           for x in ("convlstm_fwd", "convlstm_bwd")):
        raise AssertionError(f"single skipped the ConvLSTM kernels in {k} "
                             f"steps: {s['launches']}, "
                             f"{s['launches_per_step']}")
    if s["no_gradient"]:
        raise AssertionError(f"single: ConvLSTM parameters without a "
                             f"gradient: {s['no_gradient']}")
    bad = _parity_failures({"single": s["parity"]})
    if bad:
        raise AssertionError(f"card and CPU single steps disagree (loss, "
                             f"gradients, metrics): {bad}")


# the AI-DEAL PM step pair's ConvLSTM launches per net trained with a
# gradient under remat: its forward (ne echoes; remat leaves the ConvLSTM
# front out, so no second forward), the backward's state recompute (ne - 1)
# and sweep (ne echoes and the reduction); the frozen net's forward (ne).
# Two such steps make a pair.
UNSUP_REMAT_PAIR = {"convlstm_fwd_bf16": 2 * (NE + (NE - 1) + NE),
                    "convlstm_bwd_bf16": 2 * (NE + 1)}


# the bf16 step gate (card against CPU, `bf16_step_gate`): leaves whose CPU
# bf16 gradient lies within BF16_LEAF_SEL of the float32 one (of the leaf's
# own float32 scale) are "resolved"; on them the card may lie BF16_LEAF_TOL
# of that scale from the CPU; the whole gradient BF16_GRAD_TOL of the CPU
# bf16 step's scale; the loss BF16_LOSS_FACTOR times bf16's own effect on
# it; and the card's step must be at least BF16_APPLIED of bf16's effect on
# the gradient away from float32
BF16_LEAF_SEL, BF16_LEAF_TOL, BF16_GRAD_TOL = 0.1, 0.25, 0.75
BF16_LOSS_FACTOR, BF16_APPLIED = 0.25, 0.1


def bf16_step_gate(run: dict, ref: dict, f32: dict) -> dict:
    """A bf16 step `run` (loss, grads) held to the bf16 step `ref` of another
    device, with `f32` (the float32 step from the same weights) as the
    witness. At random weights most of a bf16 gradient is rounding noise
    (the AI-DEAL FM step's CPU bf16 gradient lies ~1.25 of scale from
    float32 at 96², no leaf within a tenth of its own scale; PERF.md
    §6), so the gradient is held where it is resolved and as a whole on
    a scale a wrong step leaves:

    - loss: |run − ref| ≤ BF16_LOSS_FACTOR · |ref − f32|;
    - whole gradient: max |run − ref| ≤ BF16_GRAD_TOL · max |ref| (a zero
      gradient reads 1, a sign-flipped one 2);
    - resolved leaves (|ref − f32| ≤ BF16_LEAF_SEL · max |f32| of the
      leaf): |run − ref| ≤ BF16_LEAF_TOL · max |f32| of the leaf;
    - bf16 applied: max |run − f32| ≥ BF16_APPLIED · max |ref − f32| (on
      the f32 scale), which the float32 step fails.

    Returns the readings and `failures`, the names of the rules broken."""
    g, r, w = run["grads"], ref["grads"], f32["grads"]
    if set(g) != set(r) or set(r) != set(w):
        raise AssertionError("gradient leaves differ")

    def gap(a, b, k):
        return float((a[k] - b[k]).abs().max())

    scale32 = max(float(v.abs().max()) for v in w.values())
    scale_ref = max(float(v.abs().max()) for v in r.values())
    resolved = {}
    for k in w:
        s_k = float(w[k].abs().max())
        if s_k > 0 and gap(r, w, k) <= BF16_LEAF_SEL * s_k:
            resolved[k] = gap(g, r, k) / s_k
    out = dict(
        loss=run["loss"], loss_ref=ref["loss"], loss_f32=f32["loss"],
        loss_gap=abs(run["loss"] - ref["loss"]),
        loss_bf16_effect=abs(ref["loss"] - f32["loss"]),
        grad_gap=max(gap(g, r, k) for k in w) / scale_ref,
        resolved_leaves=len(resolved),
        resolved_worst=max(resolved.values(), default=0.0),
        resolved_worst_leaf=max(resolved, key=resolved.get, default=None),
        run_vs_f32=max(gap(g, w, k) for k in w) / scale32,
        ref_vs_f32=max(gap(r, w, k) for k in w) / scale32)
    out["failures"] = [name for name, bad in (
        ("loss", out["loss_gap"] > BF16_LOSS_FACTOR * out["loss_bf16_effect"]),
        ("gradient", out["grad_gap"] > BF16_GRAD_TOL),
        ("resolved leaves", out["resolved_worst"] > BF16_LEAF_TOL),
        ("bf16 applied", out["run_vs_f32"]
         < BF16_APPLIED * out["ref_vs_f32"])) if bad]
    return out


def options_step_parity(dev, size: int, batch: int, f: int) -> dict:
    """One bf16 FM step and one bf16 R2 step on `dev` and on the CPU from the
    same float32 weights and batch (the noisy synthetic cohort of
    `step_parity`), the card's held to the CPU's by `bf16_step_gate` with
    the CPU's float32 steps as the witness. Three controls run through the
    same gate and must fail it: the CPU's float32 step, the card's step
    with its gradient zeroed, and with it sign-flipped."""
    import copy

    import numpy as np
    import torch
    from ideal_gan_tpu_torch.cli.common import synthetic_dataset
    from ideal_gan_tpu_torch.train import unsup

    cpu = torch.device("cpu")
    cfg = dict(unsup.DEFAULTS, n_G_filters=f, out_vars="PM")
    cfg_bf16 = dict(cfg, bf16=True)
    clean, _, te = synthetic_dataset(batch, h=size, w=size, ne=NE, seed=1)
    acqs = clean + 1e-3 * np.random.default_rng(2).normal(
        size=clean.shape).astype(np.float32)
    nets = unsup.build_models(cfg)
    gen = torch.Generator().manual_seed(3)
    for net in nets:
        net.init_params(gen)
    nets_bf16 = unsup.build_models(cfg_bf16)
    for a, b in zip(nets_bf16, nets):
        a.load_state_dict(b.state_dict())

    def run(c, ns, where):
        return _steps(c, [copy.deepcopy(n).to(where) for n in ns], acqs, te,
                      where, ("fm", "r2"))

    card, ref = run(cfg_bf16, nets_bf16, dev), run(cfg_bf16, nets_bf16, cpu)
    f32 = run(cfg, nets, cpu)
    out = {}
    for step in ("fm", "r2"):
        res = bf16_step_gate(card[step], ref[step], f32[step])
        res["within_gate"] = not res["failures"]
        g = card[step]["grads"]
        controls = {
            "f32_step": f32[step],
            "zero_gradient": dict(card[step], grads={
                k: torch.zeros_like(v) for k, v in g.items()}),
            "flipped_gradient": dict(card[step], grads={
                k: -v for k, v in g.items()})}
        res["controls"] = {
            name: bf16_step_gate(c, ref[step], f32[step])["failures"]
            for name, c in controls.items()}
        res["controls_fail"] = all(res["controls"].values())
        out[step] = res
    out["gate"] = (f"bf16_step_gate: loss <= {BF16_LOSS_FACTOR:g} x bf16's "
                   f"effect; gradient <= {BF16_GRAD_TOL:g} of the CPU bf16 "
                   f"scale; leaves the CPU's bf16 resolves to "
                   f"{BF16_LEAF_SEL:g}: <= {BF16_LEAF_TOL:g} of their scale; "
                   f">= {BF16_APPLIED:g} x bf16's effect from float32; the "
                   f"f32, zeroed and flipped controls fail it")
    return out


def micro_step_parity(dev, size: int, batch: int, f: int,
                      micro: int = 2) -> dict:
    """VET-Net's float32 generator gradients with `--microbatch micro`
    against the full-batch step on the card, from the same weights, maps,
    TE train and noise (the microbatched step's chunks take the noise's
    rows in order), at the step gates (loss 2e-5 relative, every gradient
    leaf 2e-2 of scale, TF32 off); then both steps timed with their peak
    memory at PyTorch's defaults."""
    import torch
    from ideal_gan_tpu_torch.cli.common import load_cohorts
    from ideal_gan_tpu_torch.train import teaug

    cfg = dict(teaug.DEFAULTS, n_G_filters=f)
    gen = torch.Generator().manual_seed(5)
    model = teaug.build_model(cfg)
    model.init_params(gen)
    model.to(dev)
    _, maps, _ = load_cohorts(dict(cfg, synthetic=batch, data_size=size))
    B = torch.from_numpy(maps).to(dev)
    te = teaug.sample_te(gen, cfg, batch).to(dev)
    noise = teaug.draw_noise(B, te, torch.Generator(device=dev)
                             .manual_seed(6))
    runs = {}
    set_tf32(False)
    for name, m in (("full", 0), ("micro", micro)):
        grad_fn = teaug.make_grad_fn(dict(cfg, microbatch=m), model)
        model.zero_grad()
        loss, _ = grad_fn(B, te, noise)
        runs[name] = dict(loss=float(loss.detach()), grads=_grads(model))
    res = _compare(runs["micro"], runs["full"])
    res["within_gate"] = (res["loss_rel_diff"] <= 2e-5
                          and res["grad_max_rel"] <= 2e-2)
    set_tf32(True)  # the steps timed at PyTorch's defaults
    for name, m in (("full", 0), ("micro", micro)):
        step, tx = teaug.make_train_step(dict(cfg, microbatch=m), model)
        state = teaug.TEAugState(model, tx(list(model.parameters())))
        noise_gen = torch.Generator(device=dev).manual_seed(7)
        res[f"{name}_step"] = steady_step(
            dev, lambda: step(state, (B, te), noise_gen), batch)
    return res


def options_phase(dev, out_dir: Path, size: int = SIZE, n: int = 16,
                  batch: int = NB_SERVE, parity_size: int = 96,
                  parity_batch: int = 2, f_main: int = F_MAIN,
                  f_teaug: int = F_TEAUG) -> dict:
    """The trainers' bf16, remat and microbatch options at full width, each
    CLI run with the launch counters read around it:

    (a) `cli.train_unsup --out_vars PM --bf16 1 --remat 1` (AI-DEAL, F=36,
        `size`², batch 8, 2 epochs of n/batch step pairs): both bf16
        ConvLSTM kernels run (the FM net at Cin 2, the R2* net at Cin 1),
        the f32 ones not at all; the launches against `UNSUP_REMAT_PAIR`
        (exactly: remat adds no ConvLSTM launch), finite losses, the peak
        memory; then `options_step_parity` at `parity_size`²;
    (b) `cli.train_teaug --bf16 1 --remat 1` (VET-Net, F=72, one epoch),
        then three steady steps timed with their peak memory;
    (c) `cli.train_teaug --microbatch 2` (VET-Net, F=72, float32, one
        epoch: the synthesis kernel once a chunk), then `micro_step_parity`
        (the microbatched gradients against the full batch's on the same
        noise, and both steps timed: the float32 full-batch step is (b)'s
        yardstick)."""
    import torch
    from ideal_gan_tpu_torch.cli import train_teaug, train_unsup
    from ideal_gan_tpu_torch.cli.common import load_cohorts
    from ideal_gan_tpu_torch.train import teaug

    def argv(sub, *extra):
        return ["--synthetic", str(n), "--data_size", str(size),
                "--batch_size", str(batch), "--seed", "0", "--device",
                str(dev), "--output_base", str(out_dir / sub), *extra]

    res, wall, launches, peak = counted_peak(dev, lambda: train_unsup.main(
        argv("unsup", "--epochs", "2", "--out_vars", "PM", "--n_G_filters",
             str(f_main), "--bf16", "1", "--remat", "1")))
    pairs = sum(ep["steps"] for ep in res["epochs"])
    want = {k: v * pairs for k, v in UNSUP_REMAT_PAIR.items()}
    unsup_run = dict(
        launches=launches, wall_s=wall, epochs=res["epochs"],
        step_pairs=pairs, expected_launches=want,
        launches_as_expected=all(launches[k] == v for k, v in want.items()),
        peak_memory_gb=peak,
        ms_per_step_pair=res["epochs"][-1]["seconds"]
        / res["epochs"][-1]["steps"] * 1e3,
        finite=_finite_losses(res["epochs"]))
    set_tf32(False)
    unsup_run["parity"] = options_step_parity(dev, parity_size,
                                              parity_batch, f_main)
    unsup_run["parity_shape"] = dict(size=parity_size, batch=parity_batch,
                                     F=f_main)
    set_tf32(True)
    del res

    res, wall, launches, peak = counted_peak(dev, lambda: train_teaug.main(
        argv("teaug_bf16", "--epochs", "1", "--n_G_filters", str(f_teaug),
             "--bf16", "1", "--remat", "1")))
    cfg = dict(teaug.DEFAULTS, n_G_filters=f_teaug, bf16=True, remat=True)
    state = res["state"]
    _, maps, _ = load_cohorts(dict(cfg, synthetic=batch, data_size=size))
    B = torch.from_numpy(maps).to(dev)
    te = teaug.sample_te(torch.Generator().manual_seed(1), cfg, batch).to(dev)
    step, _ = teaug.make_train_step(cfg, state.model)
    noise_gen = torch.Generator(device=dev).manual_seed(2)
    teaug_run = dict(launches=launches, wall_s=wall, epochs=res["epochs"],
                     steps=state.step, peak_memory_gb_cli=peak,
                     finite=_finite_losses(res["epochs"]),
                     **steady_step(dev, lambda: step(state, (B, te),
                                                     noise_gen), batch))
    del res, state, step, B
    torch.cuda.empty_cache()

    res, wall, launches = counted(dev, lambda: train_teaug.main(
        argv("teaug_micro", "--epochs", "1", "--n_G_filters", str(f_teaug),
             "--microbatch", "2")))
    micro_run = dict(launches=launches, wall_s=wall, epochs=res["epochs"],
                     steps=res["state"].step, chunks_per_step=batch // 2,
                     finite=_finite_losses(res["epochs"]))
    del res
    torch.cuda.empty_cache()
    micro_run["parity"] = micro_step_parity(dev, size, batch, f_teaug)
    return dict(unsup_bf16_remat=unsup_run, teaug_bf16_remat=teaug_run,
                teaug_microbatch=micro_run)


def check_options(o: dict) -> None:
    """The options phase's gates: (a) both bf16 ConvLSTM kernels exactly
    `UNSUP_REMAT_PAIR` times a step pair and the f32 ones never, finite
    losses, the bf16 card-vs-CPU steps within their gate and its three
    controls outside it; (b) the bf16
    kernels at least once a step, finite losses; (c) the synthesis kernel
    once a chunk and the f32 ConvLSTM kernels at least once a step, finite
    losses, the microbatched step within the step gates of the full
    batch."""
    u, t, m = (o[k] for k in ("unsup_bf16_remat", "teaug_bf16_remat",
                              "teaug_microbatch"))
    off = {k: (u["launches"][k], v) for k, v in
           u["expected_launches"].items() if u["launches"][k] != v}
    if off or u["launches"]["convlstm_fwd"] or u["launches"]["convlstm_bwd"]:
        raise AssertionError(f"bf16 unsup path skipped the bf16 kernels or "
                             f"ran the f32 ones: {u['launches']}")
    bad = {s: u["parity"][s] for s in ("fm", "r2")
           if not u["parity"][s]["within_gate"]
           or not u["parity"][s]["controls_fail"]}
    if not u["finite"] or bad:
        raise AssertionError(f"bf16 unsup: losses {u['epochs']}, card vs CPU "
                             f"bf16 steps {bad}")
    k = t["steps"]
    if not t["finite"] or any(t["launches"][x] < k for x in (
            "convlstm_fwd_bf16", "convlstm_bwd_bf16")):
        raise AssertionError(f"bf16 teaug skipped the bf16 kernels in {k} "
                             f"steps or lost its losses: {t['launches']}, "
                             f"{t['epochs']}")
    k = m["steps"]
    if not m["finite"] or m["launches"]["ideal_forward"] \
            != k * m["chunks_per_step"] or any(
                m["launches"][x] < k for x in ("convlstm_fwd",
                                               "convlstm_bwd")):
        raise AssertionError(f"microbatched teaug skipped kernels in {k} "
                             f"steps: {m['launches']}, {m['epochs']}")
    if not m["parity"]["within_gate"]:
        raise AssertionError(f"microbatched and full-batch VET-Net steps "
                             f"disagree: {m['parity']}")


# the run-record CLI: U-Net PM at F=72, 44 slices at batch 2 hold out 4 for
# validation and leave 40 for 20 steps an epoch, so each epoch's last step
# is a summary step
RECORD_SLICES, RECORD_BATCH = 44, 2


def _summary_gaps(scalars: dict, epochs: list, steps_per_epoch: int,
                  name: str = "G_losses") -> dict:
    """For each summary step that ends an epoch, the metrics of that
    epoch's record (its last step's) against the event file's scalars:
    {tag: |float32(metric) − scalar|}, and the tags the file misses."""
    import numpy as np
    gaps, missing = {}, []
    for ep in epochs:
        step = ep["epoch"] * steps_per_epoch
        for k, v in ep.items():
            if not isinstance(v, float) or k == "seconds":
                continue
            got = dict(scalars.get(f"{name}/{k}", []))
            if step not in got:
                missing.append(f"{name}/{k}@{step}")
                continue
            gaps[f"{name}/{k}@{step}"] = abs(float(np.float32(v)) - got[step])
    return dict(max_gap=max(gaps.values(), default=None), compared=len(gaps),
                missing=missing)


def trainloop_run(dev, out_dir: Path, size: int, f: int, batch: int,
                  steps: int = 10) -> dict:
    """`train.common.TrainLoop` driving the AI-DEAL FM step (the cycle and
    both ConvLSTM kernels) for 2 epochs of `steps` steps with a checkpoint
    every epoch, counted, then again for 3 epochs: it must resume from
    epoch 2 and run only the third."""
    import numpy as np
    import torch
    from ideal_gan_tpu_torch.cli.common import load_cohorts
    from ideal_gan_tpu_torch.train import unsup
    from ideal_gan_tpu_torch.train.common import TrainLoop, batch_iterator
    from ideal_gan_tpu_torch.utils.summary import read_scalars

    cfg = dict(unsup.DEFAULTS, n_G_filters=f, batch_size=batch,
               total_steps=3 * steps)
    acqs, _, te = load_cohorts(dict(cfg, synthetic=batch * steps,
                                    data_size=size))
    g_fm, g_r2 = unsup.build_models(cfg)
    step_fn, tx = unsup.make_train_step(cfg, g_fm, g_r2)
    state = unsup.init_state(cfg, g_fm, g_r2, tx,
                             torch.Generator().manual_seed(0), dev)
    calls = []

    def step(st, b):
        calls.append(1)
        return step_fn(st, b)

    def batches():
        return batch_iterator((acqs, te), batch, np.random.default_rng(0))

    runs = []
    for epochs in (2, 3):
        loop = TrainLoop(step, str(out_dir), epoch_ckpt=1, device=dev)
        calls.clear()
        _, wall, launches = counted(dev, lambda: loop.run(state, epochs,
                                                          batches))
        runs.append(dict(steps=len(calls), wall_s=wall, launches=launches,
                         checkpoints=loop.record.ckpt.steps()))
    scalars = read_scalars(out_dir / "summaries" / "train")
    return dict(runs=runs, summary_steps=sorted(
        {st for v in scalars.values() for st, _ in v}),
        summary_tags=len(scalars), steps_per_epoch=steps)


def record_cost(dev, state, out_dir: Path, size: int, f: int, batch: int,
                steps: int = 40) -> dict:
    """The U-Net PM step's ms on a fixed batch without and with the run
    record's per-step call (`RunRecord.step`: host floats and a summary
    every 20 steps), `steps` steps a run, in turns off, on, on, off after
    a warm-up run, each run ending in a synchronisation."""
    import torch
    from ideal_gan_tpu_torch.cli.common import load_cohorts
    from ideal_gan_tpu_torch.train.common import RunRecord
    from ideal_gan_tpu_torch.train import sup

    cfg = dict(sup.DEFAULTS, n_G_filters=f, G_model="U-Net", out_vars="PM")
    step_fn, _ = sup.make_train_step(cfg, state.model)
    data = load_cohorts(dict(cfg, synthetic=batch, data_size=size))
    bt = tuple(torch.from_numpy(x).to(dev) for x in data)
    gen = torch.Generator(device=dev).manual_seed(0)
    record = RunRecord(dict(output_dir=str(out_dir), epochs=1, epoch_ckpt=1),
                       state, 1)

    def run(on: bool) -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        st = state
        for _ in range(steps):
            st, metrics = step_fn(st, bt, gen)
            if on:
                record.step(metrics)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3 / steps

    try:
        run(False)
        times = {"off": [], "on": []}
        for on in (False, True, True, False):
            times["on" if on else "off"].append(run(on))
    finally:
        record.close()
    return dict(ms_per_step=times, steps_per_run=steps,
                summaries_written=record.gstep // 20)


def record_phase(dev, out_dir: Path, size: int = SIZE, f: int = F_TEAUG,
                 n: int = RECORD_SLICES, batch: int = RECORD_BATCH,
                 loop_f: int = F_MAIN, loop_steps: int = 10,
                 cost_steps: int = 40) -> dict:
    """The run record: `cli.train_sup --G_model U-Net --out_vars PM` for 2
    epochs of 20 steps (counted), its settings.yml read back, its G_losses
    scalars (train and validation) against the epoch records at the
    summary steps, its checkpoints; a rerun for a third epoch under
    `--profile_dir` that must resume from epoch 2 and write a trace with
    device kernels; `TrainLoop` on the card (`trainloop_run`); the step's
    cost of the record (`record_cost`)."""
    import json as _json

    from ideal_gan_tpu_torch.cli import train_sup
    from ideal_gan_tpu_torch.train import sup
    from ideal_gan_tpu_torch.utils import Checkpoint, Config
    from ideal_gan_tpu_torch.utils.summary import read_scalars

    flags = dict(synthetic=n, data_size=size, batch_size=batch,
                 n_G_filters=f, G_model="U-Net", out_vars="PM", epochs=2,
                 epoch_ckpt=2, seed=0, device=str(dev),
                 output_base=str(out_dir))
    argv = [x for k, v in flags.items() for x in (f"--{k}", str(v))]
    result, wall, launches = counted(dev, lambda: train_sup.main(argv))
    exp = out_dir / sup.DEFAULTS["dataset"]
    saved = Config.load(exp / "settings.yml")
    settings_diff = {k: (saved.get(k), v)
                     for k, v in {**sup.DEFAULTS, **flags}.items()
                     if saved.get(k) != v}
    spe = result["epochs"][0]["steps"]
    train_gaps = _summary_gaps(read_scalars(exp / "summaries" / "train"),
                               result["epochs"], spe)
    val_scalars = read_scalars(exp / "summaries" / "validation")
    val_gaps = _summary_gaps(val_scalars, [dict(epoch=e["epoch"], **e["val"])
                                           for e in result["epochs"]], spe)
    ckpts = Checkpoint(exp / "checkpoints").steps()

    prof = out_dir / "profile"
    flags3 = dict(flags, epochs=3, profile_dir=str(prof))
    argv3 = [x for k, v in flags3.items() for x in (f"--{k}", str(v))]
    again, wall3, launches3 = counted(dev, lambda: train_sup.main(argv3))
    trace = prof / "trace.json"
    events = _json.loads(trace.read_text())["traceEvents"] \
        if trace.exists() else []
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    resumed_gaps = _summary_gaps(read_scalars(exp / "summaries" / "train"),
                                 again["epochs"], spe)
    loop = trainloop_run(dev, out_dir / "loop", size, loop_f, batch,
                         loop_steps)
    resumed_step = again["state"].step
    cost = record_cost(dev, again["state"], out_dir / "cost", size, f, batch,
                       cost_steps)
    return dict(record_cost=cost, launches=launches, wall_s=wall,
                steps_per_epoch=spe,
                epochs=result["epochs"], settings_diff=settings_diff,
                summaries=train_gaps, validation=val_gaps,
                checkpoints=ckpts, resumed_epochs=[e["epoch"] for e in
                                                   again["epochs"]],
                resumed_step=resumed_step,
                resumed_summaries=resumed_gaps, resumed_wall_s=wall3,
                resumed_launches=launches3,
                checkpoints_after_resume=Checkpoint(
                    exp / "checkpoints").steps(),
                trace_events=len(events), trace_kernels=kernels,
                trainloop=loop, config=dict(size=size, F=f, slices=n,
                                            batch=batch))


def check_record(r: dict, on_card: bool = True) -> None:
    """The record phase's gates: settings read back equal; every metric of
    the epochs' last steps equals its scalar in the train and validation
    event files (float32); checkpoints at the last epoch before and after
    the resume, which ran only the third epoch; a trace (with device
    kernels on the card); TrainLoop's 20 + 10 steps, its summary at step
    20, checkpoints 1–3 and the AI-DEAL kernels in its first run; the fit
    kernel once a step of the CLI's run."""
    if r["settings_diff"]:
        raise AssertionError(f"settings.yml differs: {r['settings_diff']}")
    for k in ("summaries", "validation", "resumed_summaries"):
        g = r[k]
        if g["missing"] or not g["compared"] or g["max_gap"] != 0.0:
            raise AssertionError(f"record {k}: event scalars differ from "
                                 f"the step metrics: {g}")
    if r["steps_per_epoch"] != 20 or 2 not in r["checkpoints"] \
            or r["resumed_epochs"] != [3] or r["resumed_step"] != 60 \
            or 3 not in r["checkpoints_after_resume"]:
        raise AssertionError(f"record: checkpoints or resume wrong: "
                             f"{r['steps_per_epoch']} steps an epoch, "
                             f"{r['checkpoints']}, resumed "
                             f"{r['resumed_epochs']} at step "
                             f"{r['resumed_step']}, "
                             f"{r['checkpoints_after_resume']}")
    if not r["trace_events"] or (on_card and not r["trace_kernels"]):
        raise AssertionError(f"record: --profile_dir trace has "
                             f"{r['trace_events']} events, "
                             f"{r['trace_kernels']} kernels")
    loop = r["trainloop"]
    first, second = loop["runs"]
    n = loop["steps_per_epoch"]
    if (first["steps"], second["steps"]) != (2 * n, n) \
            or loop["summary_steps"] != [20] \
            or second["checkpoints"] != [1, 2, 3]:
        raise AssertionError(f"TrainLoop: steps {first['steps']}, "
                             f"{second['steps']}, summaries at "
                             f"{loop['summary_steps']}, checkpoints "
                             f"{second['checkpoints']}")
    steps = 2 * r["steps_per_epoch"]
    if first["launches"]["ideal_cycle"] < 2 * n or any(
            first["launches"][k] < 2 * n
            for k in ("convlstm_fwd", "convlstm_bwd")) \
            or r["launches"]["ideal_fit"] < steps:
        raise AssertionError(f"record skipped kernels: TrainLoop "
                             f"{first['launches']}, CLI {r['launches']}")


def _reader(stream, lines):
    for line in stream:
        lines.put(line)
    lines.put(None)


def preempt_phase(dev, out_dir: Path, size: int = SIZE, f: int = F_TEAUG,
                  timeout: float = 600.0) -> dict:
    """`cli.train_sup` (U-Net PM, 4 slices at batch 2, 500 epochs) in a
    subprocess, SIGTERM after its "epoch 2/" line; then a rerun to one
    epoch past the preemption checkpoint."""
    import os
    import queue
    import re
    import signal
    import threading

    args = [sys.executable, "-m", "ideal_gan_tpu_torch.cli.train_sup",
            "--synthetic", "4", "--data_size", str(size), "--batch_size",
            "2", "--n_G_filters", str(f), "--G_model", "U-Net", "--out_vars",
            "PM", "--epochs", "500", "--epoch_ckpt", "100", "--device",
            str(dev), "--output_base", str(out_dir)]
    env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONUNBUFFERED="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen(args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()
    threading.Thread(target=_reader, args=(proc.stdout, lines),
                     daemon=True).start()
    out, signalled = [], False
    try:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                line = lines.get(timeout=max(deadline - time.monotonic(), 0))
            except queue.Empty:
                break
            if line is None:
                break
            out.append(line)
            if line.startswith("epoch 2/"):
                proc.send_signal(signal.SIGTERM)
                signalled = True
                break
        rc = proc.wait(timeout=timeout)
        while (line := lines.get(timeout=timeout)) is not None:
            out.append(line)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(out)
    m = re.search(r"preempted: checkpointed epoch (\d+), exiting", text)
    epoch = int(m.group(1)) if m else None
    ckdir = out_dir / "WF-sup" / "checkpoints"
    ckpts = sorted(int(p.stem.split("-")[1]) for p in ckdir.glob("ckpt-*.pt"))
    resume = None
    if epoch is not None:
        args[args.index("--epochs") + 1] = str(epoch + 1)
        res = subprocess.run(args, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=timeout)
        resume = dict(rc=res.returncode, resumed=f"resumed from epoch "
                      f"{epoch}" in res.stdout, tail=res.stdout[-400:])
    return dict(signalled=signalled, rc=rc, preempted_epoch=epoch,
                checkpoints=ckpts, resume=resume, tail=text[-400:],
                wall_s=time.perf_counter() - t0)


def check_preempt(p: dict) -> None:
    """Exit 0 after the signal, "preempted: checkpointed epoch N", its
    checkpoint on disk, and a rerun that resumed from it and exited 0."""
    r = p["resume"]
    if not p["signalled"] or p["rc"] != 0 or p["preempted_epoch"] is None \
            or p["preempted_epoch"] not in p["checkpoints"] or r is None \
            or r["rc"] != 0 or not r["resumed"]:
        raise AssertionError(f"preemption: {p}")


def roi_crops(n: int, size: int, seed: int = 7):
    """Two ROI anchors a slice for `n` slices, inside the synthetic
    cohort's body ellipse."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lo, hi = int(0.3 * size), int(0.6 * size)
    return (np.arange(n), rng.integers(lo, hi, size=(n, 2)),
            rng.integers(lo, hi, size=(n, 2)))


def roi_phase(dev, out_dir: Path, exp_dir: Path, size: int = SIZE,
              n: int = 16, batch: int = NB_SERVE) -> dict:
    """`cli.roi_analysis.main --model_sel AI-DEAL` served from `exp_dir`
    (the train phase's run) on `n` synthetic slices with two ROIs a slice,
    counted, at the run's TF32 setting; its workbook read back against
    `roi_stats` of the maps `infer_maps` returned; then, as the e2e phase
    compares, the first chunk served again with TF32 off and its ROI values
    against the CPU's where the ROI's median |W+F| (CPU) > 0.2, the e2e
    phase's threshold (random nets make water and fat cancel at single
    voxels), and the counted run's ROI values against the CPU's beside
    them (not gated: cuDNN's TF32 convolutions)."""
    import numpy as np
    from ideal_gan_tpu_torch.cli import roi_analysis
    from ideal_gan_tpu_torch.cli.common import load_cohorts
    from ideal_gan_tpu_torch.eval import roi as roi_mod
    from ideal_gan_tpu_torch.eval.export import read_xlsx, save_crops

    crops = out_dir / "crops.npy"
    frms, c1, c2 = roi_crops(n, size)
    save_crops(str(crops), frms, c1, c2)
    argv = ["--model_sel", "AI-DEAL", "--experiment_dir", str(exp_dir),
            "--synthetic", str(n), "--data_size", str(size), "--infer_batch",
            str(batch), "--crops_file", str(crops), "--dataset", "roi",
            "--device", str(dev), "--output_base", str(out_dir)]
    res, wall, launches = counted(dev, lambda: roi_analysis.main(argv))
    maps = res["maps"]
    pdff = roi_mod.maps_to_display(maps)[0]
    want_m = roi_mod.roi_stats(pdff, str(crops))
    want_r = roi_mod.roi_stats(res["stack_gt"], str(crops))
    book = read_xlsx(str(res["xlsx"]))
    want_rows = {
        sheet: [[s, r, m, m - r] for s, r, m in zip(want_m.slices, vr, vm)]
        for sheet, vm, vr in (("RHL", want_m.values_1, want_r.values_1),
                              ("LHL", want_m.values_2, want_r.values_2))}
    workbook_equal = all(book[k][1:] == v for k, v in want_rows.items())

    cfg = dict(roi_analysis.DEFAULTS, experiment_dir=str(exp_dir),
               synthetic=n, data_size=size)
    acqs, _, te = load_cohorts(cfg)
    a, t = acqs[:batch], te[:batch]
    set_tf32(False)
    try:
        card = roi_analysis._per_slice(
            roi_analysis.make_infer_run(cfg, a, dev), a, t, batch, dev)[0]
    finally:
        set_tf32(True)
    cpu = roi_analysis._per_slice(roi_analysis.make_infer_run(cfg, a, "cpu"),
                                  a, t, batch, "cpu")[0]
    pdff_card = roi_mod.maps_to_display(card)[0]
    pdff_cpu = roi_mod.maps_to_display(cpu)[0]
    w_f = cpu[:, 0] + cpu[:, 1]
    tot = np.abs(w_f[..., 0] + 1j * w_f[..., 1])
    gaps, tf32_gaps, skipped = [], [], 0
    for i in range(batch):
        for lx, sy in (c1[i], c2[i]):
            box = np.s_[sy:sy + 9, lx:lx + 9]
            if np.median(tot[i][box]) <= 0.2:
                skipped += 1
                continue
            want = roi_mod.roi_median(pdff_cpu[i], lx, sy)
            gaps.append(abs(roi_mod.roi_median(pdff_card[i], lx, sy) - want))
            tf32_gaps.append(abs(roi_mod.roi_median(pdff[i], lx, sy) - want))
    return dict(launches=launches, wall_s=wall, rois=2 * n,
                workbook_equal=workbook_equal,
                mean_bias=float(np.mean(res["errors"])),
                within_envelope=res["within"],
                roi_max_abs_err_vs_cpu=max(gaps, default=None),
                roi_tf32_max_abs_diff_vs_cpu=max(tf32_gaps, default=None),
                rois_compared=len(gaps), rois_not_compared=skipped,
                finite=bool(np.isfinite(maps).all()))


def check_roi(r: dict, batch: int = NB_SERVE, n: int = 16) -> None:
    """The workbook equals `roi_stats` of the served maps; the card's ROI
    PDFF within the e2e phase's 5e-3 of the CPU's where the ROI's median
    |W+F| > 0.2; the fit and ConvLSTM forward once a chunk (12 a
    chunk)."""
    chunks = -(-n // batch)
    if not r["workbook_equal"] or not r["finite"]:
        raise AssertionError(f"roi workbook or maps wrong: {r}")
    if not r["rois_compared"] or r["roi_max_abs_err_vs_cpu"] > 5e-3:
        raise AssertionError(f"card and CPU ROI values disagree: {r}")
    if r["launches"]["ideal_fit"] < chunks \
            or r["launches"]["convlstm_fwd"] < 12 * chunks:
        raise AssertionError(f"roi path skipped kernels: {r['launches']}")


def phantom_phase(dev, out_dir: Path) -> dict:
    """The port's phantom (`cli.phantom_parity`) at 1.5 T and 3 T on the
    card at the run's TF32 setting, each field counted: synthesis, the
    complex fit and the magnitude fit kernels; the 44 vial medians against
    `PHANTOM_PARITY.json`; the same with TF32 off, as a witness that the
    setting no longer moves them (the kernels' small matrices are built by
    torch matmuls at full precision); then `cli.roi_realphantom`'s
    GraphCuts path on the 1.5 T phantom with the 11 vial ROIs, which
    writes its workbook."""
    import numpy as np
    from ideal_gan_tpu_torch.cli import phantom_parity as pp
    from ideal_gan_tpu_torch.cli import roi_realphantom
    from ideal_gan_tpu_torch.cli.common import setup_experiment
    from ideal_gan_tpu_torch.eval.export import read_xlsx, save_crops

    ref = json.loads(pp.PARITY_FILE.read_text())
    fields = {}
    for key in pp.FIELDS:
        res, wall, launches = counted(dev, lambda: pp.field_result(key, dev,
                                                                   ref))
        fields[key] = dict(launches=launches, wall_s=wall, **res)
    set_tf32(False)
    try:
        off = {key: pp.field_result(key, dev, ref)["medians"]
               for key in pp.FIELDS}
    finally:
        set_tf32(True)
    tf32_moves = max(abs(a - b) for key in pp.FIELDS
                     for path, meds in off[key].items()
                     for a, b in zip(meds, fields[key]["medians"][path]))
    crops = out_dir / "vials.npy"
    c1 = pp.vial_crops()
    save_crops(str(crops), np.zeros(len(c1), int), c1, [(-1, -1)] * len(c1))
    cfg = setup_experiment(roi_realphantom.DEFAULTS, [
        "--crops_file", str(crops), "--device", str(dev), "--output_base",
        str(out_dir)])
    acqs, maps, te, _ = pp.build_phantom(1.5, dev)
    gc = roi_realphantom.evaluate(cfg, acqs.cpu().numpy(),
                                  maps.cpu().numpy(), te.cpu().numpy())
    sheet = read_xlsx(str(gc["xlsx"]))["Phantom"]
    return dict(fields=fields, gt=list(pp.GT_VALS),
                tf32_off_max_median_diff=tf32_moves,
                graphcuts_bias={str(g): b for g, b in gc["bias"].items()},
                graphcuts_rows=len(sheet) - 1)


def check_phantom(p: dict) -> None:
    """Every vial median within `phantom_parity.PARITY_TOL` (5e-4) of
    PHANTOM_PARITY.json's, the complex path within 0.03 of the ground
    truth, one launch of each of the three kernels a field, the medians
    with TF32 off equal to these, and 11 vials in the GraphCuts
    workbook."""
    from ideal_gan_tpu_torch.cli import phantom_parity as pp
    for key, f in p["fields"].items():
        if not pp.passes(f):
            raise AssertionError(f"phantom {key}: {f}")
        if any(f["launches"][k] != 1 for k in
               ("ideal_forward", "ideal_fit", "ideal_mag_fit")):
            raise AssertionError(f"phantom {key} skipped kernels: "
                                 f"{f['launches']}")
    if p["tf32_off_max_median_diff"] != 0.0:
        raise AssertionError(f"the TF32 setting moves the phantom's medians "
                             f"by {p['tf32_off_max_median_diff']}")
    if p["graphcuts_rows"] != 11:
        raise AssertionError(f"GraphCuts workbook: {p['graphcuts_rows']} "
                             "vials")


def convlstm_batch_elementwise(dev, size: int = GAN_SIZE, f: int = F_MAIN,
                               cin: int = 2) -> dict:
    """The ConvLSTM kernels batch-elementwise at the GAN encoder's shape, in
    float32 and bf16: the forward's h and the backward's dx at nb=2 must
    equal the two nb=1 launches' bit for bit (a sample's result may not
    depend on the batch around it); dk and db, which sum over the batch,
    are held to the sum of the two nb=1 results (1e-5 of scale in float32,
    two bf16 ulps of scale in bf16) and reported (`check_batch_elementwise`
    gates it; the CPU's plain versions sum in batch-dependent orders)."""
    import torch
    from ideal_gan_tpu_torch import ops
    out = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 * BF16_U)):
        _, (x, k, b, g) = _bf16_inputs(dev, cin, f, 2, size, 30, 1.5)
        x, k, b, g = (t.to(dtype) for t in (x, k, b, g))
        one = [ops.convlstm_forward(x[i:i + 1].contiguous(), k, b)
               for i in range(2)]
        h_equal = torch.equal(ops.convlstm_forward(x, k, b),
                              torch.cat(one))
        bwd = ops.convlstm_backward(x, k, b, g)
        parts = [ops.convlstm_backward(x[i:i + 1].contiguous(), k, b,
                                       g[i:i + 1].contiguous())
                 for i in range(2)]
        dx_equal = torch.equal(bwd[0], torch.cat([p[0] for p in parts]))
        red = {}
        for j, name in ((1, "dk"), (2, "db")):
            ref = (parts[0][j].float() + parts[1][j].float())
            red[name] = float((bwd[j].float() - ref).abs().max()) / max(
                float(ref.abs().max()), 1e-30)
        out["float32" if dtype == torch.float32 else "bfloat16"] = dict(
            h_bit_equal=h_equal, dx_bit_equal=dx_equal,
            reduced_rel_diff=red, reduced_tol=tol,
            ok=h_equal and dx_equal and max(red.values()) <= tol)
        del x, g, bwd, parts, one
        torch.cuda.empty_cache() if dev.type == "cuda" else None
    return dict(shape=dict(cin=cin, F=f, size=size, nb=2), **out)


def check_batch_elementwise(be: dict) -> None:
    bad = {k: v for k, v in be.items() if isinstance(v, dict) and "ok" in v
           and not v["ok"]}
    if bad:
        raise AssertionError(f"the ConvLSTM kernels are not "
                             f"batch-elementwise: {bad}")


# the per-voxel kernels' three phasor forms: the uniform-TE recurrence, one
# exp per echo, and the per-row test (uniform_te=None)
PHASOR_FORMS = {"uniform": True, "per_echo": False, "per_row": None}


def _te_rows(form: str, dev, ne: int = NE):
    """A (2, ne, 1) TE train whose two rows differ: the 1.5 T and 3 T
    protocol trains for the recurrence, two jittered trains for the
    per-echo form, one of each for the per-row test."""
    import torch
    from ideal_gan_tpu_torch import physics
    uni = [physics.te_train_for_field(ne, 1, f, device=dev)
           for f in (1.5, 3.0)]
    jit = [physics.sample_te_train(torch.Generator().manual_seed(s), ne,
                                   device=dev) for s in (5, 6)]
    rows = {"uniform": uni, "per_echo": jit, "per_row": [uni[0], jit[0]]}
    return torch.cat(rows[form])


def per_voxel_batch_elementwise(dev, size: int = SIZE) -> dict:
    """The four per-voxel physics kernels batch-elementwise (what the JAX
    package's `ops/partition.py` relies on): at nb=2 each output must equal
    the two nb=1 launches' outputs concatenated, bit for bit (`torch.equal`),
    in each phasor form with rows whose TE trains differ (`_te_rows`); the
    fit also through `fit_rho_planar` with f32 and bf16 echoes. Returns
    {entry: {form: bit-equal}} and "ok"; `check_per_voxel_batch_elementwise`
    gates it."""
    import torch
    from ideal_gan_tpu_torch import ops
    acqs, maps, _ = bench_inputs(2, size, dev)
    pm = (maps[:, 2:3] + 0.02).contiguous()
    smaps = maps.clone()
    smaps[:, 2, ..., 1] -= 0.1  # some R2* < 0: the synthesis clamps it
    mags = torch.linalg.vector_norm(acqs, dim=-1, keepdim=True)
    r2 = maps[:, 2:3, ..., 1:2].contiguous()
    s_re, s_im = acqs[..., 0].contiguous(), acqs[..., 1].contiguous()
    phi, r2s = pm[:, 0, ..., 0].contiguous(), pm[:, 0, ..., 1].contiguous()

    def rows(t, i):
        return t[i].contiguous()

    def planar(dtype):
        return lambda i, te, u: ops.fit_rho_planar(
            rows(s_re, i).to(dtype), rows(s_im, i).to(dtype), rows(phi, i),
            rows(r2s, i), rows(te, i), uniform_te=u)

    entries = {
        "fit_rho_fused": lambda i, te, u: (ops.fit_rho_fused(
            rows(acqs, i), rows(pm, i), rows(te, i), uniform_te=u),),
        "cycle_full_fused": lambda i, te, u: ops.cycle_full_fused(
            rows(acqs, i), rows(pm, i), rows(te, i), uniform_te=u),
        "synthesize_fused": lambda i, te, u: (ops.synthesize_fused(
            rows(smaps, i), rows(te, i), uniform_te=u),),
        "cse_mag_fused": lambda i, te, u: tuple(ops.cse_mag_fused(
            rows(mags, i), rows(r2, i), rows(te, i), uniform_te=u)),
        "fit_rho_planar_f32": planar(torch.float32),
        "fit_rho_planar_bf16": planar(torch.bfloat16),
    }
    out = {}
    with torch.no_grad():
        for name, fn in entries.items():
            out[name] = {}
            for form, u in PHASOR_FORMS.items():
                te = _te_rows(form, dev)
                whole = fn(slice(None), te, u)
                parts = [fn(slice(k, k + 1), te, u) for k in range(2)]
                out[name][form] = all(
                    torch.equal(w, torch.cat([p[j] for p in parts]))
                    for j, w in enumerate(whole))
    out["ok"] = all(all(v.values()) for k, v in out.items())
    return dict(shape=dict(nb=2, size=size, ne=NE), **out)


def check_per_voxel_batch_elementwise(be: dict) -> None:
    bad = {k: v for k, v in be.items() if isinstance(v, dict) and k != "shape"
           and not all(v.values())}
    if bad or not be["ok"]:
        raise AssertionError(f"the per-voxel kernels are not "
                             f"batch-elementwise: {bad}")


# the GAN phase: the main run at the JAX DEFAULTS with the adversary, then
# one short epoch of each option
GAN_SHORT = {"vq": {"VQ_encoder": True}, "cgan": {"cGAN": True},
             "bf16": {"bf16": True}}
D_GAN = 72  # the PatchGAN's width (gan DEFAULTS n_D_filters)
GAN_LSTM = {False: ("convlstm_fwd", "convlstm_bwd"),
            True: ("convlstm_fwd_bf16", "convlstm_bwd_bf16")}
# the ConvLSTM kernels' device kernels by name (f32 and bf16)
GAN_LSTM_FRAGMENTS = ("convlstm_echo", "gates_", "dinp_", "dk_mma",
                      "sum_slots")


def _gan_cfg(size: int, f: int, n: int, epochs: int, over=(),
             d: int = D_GAN) -> dict:
    from ideal_gan_tpu_torch.train import gan
    return dict(gan.DEFAULTS, adv_train=True, synthetic=n, data_size=size,
                n_G_filters=f, n_D_filters=d, epochs=epochs, **dict(over))


def _gan_batch(cfg: dict, dev):
    """The CLI's first batch of the cohort of `cfg` (echoes, mag/phase map
    rows, TE) on `dev`."""
    import torch
    from ideal_gan_tpu_torch.cli.common import load_cohorts
    from ideal_gan_tpu_torch.data import mag_phase_maps, maps_from_mebcrn
    acqs, maps, te = load_cohorts(cfg)
    bs = cfg["batch_size"]
    legacy = maps_from_mebcrn(torch.from_numpy(maps[:bs])).numpy()
    b = mag_phase_maps(legacy, unwrap=cfg["unwrap"])
    return tuple(torch.from_numpy(x).to(dev) for x in (acqs[:bs], b, te[:bs]))


def _lstm_devices_ms(fn, dev) -> dict | None:
    """Device ms of one call of `fn`: every kernel, and the ConvLSTM
    kernels' (by name); None on the CPU."""
    split = device_ms_by(fn, dev, {"all": "", **{
        frag: frag for frag in GAN_LSTM_FRAGMENTS}}, iters=3)
    if split is None:
        return None
    return dict(all=split["all"], convlstm=sum(
        v for k, v in split.items() if k != "all"))


def gan_run(dev, out_dir: Path, name: str, size: int, f: int, n: int,
            epochs: int, over=(), timed: bool = False,
            d: int = D_GAN) -> dict:
    """`cli.train_gan.main --adv_train 1` (with the overrides `over`) on `n`
    synthetic slices of `size`² for `epochs` epochs, counted; then one
    g-step and one d-step on the first batch, each counted alone, with the
    discriminator's u read around them; with `timed` both steps' ms, peak
    memory and device ms (all kernels, the ConvLSTM kernels; the VGG
    perceptual part and the R1 double backward each alone)."""
    import torch
    from ideal_gan_tpu_torch.cli import train_gan
    from ideal_gan_tpu_torch.losses import r1_regularization
    from ideal_gan_tpu_torch.train import gan

    cfg = _gan_cfg(size, f, n, epochs, over, d)
    argv = ["--adv_train", "1", "--synthetic", str(n), "--data_size",
            str(size), "--epochs", str(epochs), "--epoch_ckpt", str(epochs),
            "--n_G_filters", str(f), "--n_D_filters", str(d), "--seed", "0",
            "--device", str(dev), "--dataset", name, "--output_base",
            str(out_dir)]
    for k, v in dict(over).items():
        argv += [f"--{k}", str(int(v) if isinstance(v, bool) else v)]
    result, wall, launches, peak = counted_peak(
        dev, lambda: train_gan.main(argv))
    state = result["state"]
    disc = state.models.disc
    init = gan.build_models(cfg)
    gen = torch.Generator().manual_seed(0)
    for m in init:
        m.init_params(gen)
    u_init = init.disc.stats()
    u_run = disc.stats()
    no_grad = _no_gradient(state.models.enc, ("lstm.",))
    g_step, d_step, _ = gan.make_train_steps(cfg, state.models)
    batch = _gan_batch(cfg, dev)
    (_, _, fake), _, g_launches = counted(dev, lambda: g_step(state, batch))
    u_after_g = disc.stats()
    _, _, d_launches = counted(dev, lambda: d_step(state, batch[0], fake))
    u_after_d = disc.stats()

    def changed(a, b):
        return [k for k in a if not torch.equal(a[k].cpu(), b[k].cpu())]

    metrics = {k: v for ep in result["epochs"] for k, v in ep.items()
               if isinstance(v, float) and k not in ("seconds",)}
    out = dict(launches=launches, g_steps=n // cfg["batch_size"] * epochs,
               d_steps=n // cfg["batch_size"] * epochs
               * cfg["critic_train_steps"], wall_s=wall,
               peak_memory_gb=peak, epochs=result["epochs"],
               finite=all(math.isfinite(v) for v in metrics.values()),
               no_gradient=no_grad, g_step_launches=g_launches,
               d_step_launches=d_launches,
               u_changed_by_run=changed(u_init, u_run),
               u_changed_by_g_step=changed(u_run, u_after_g),
               u_changed_by_d_step=changed(u_after_g, u_after_d),
               bf16=bool(cfg["bf16"]))
    if not timed:
        return out
    g_call = lambda: g_step(state, batch)  # noqa: E731
    d_call = lambda: d_step(state, batch[0], fake)  # noqa: E731
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out["g_step_ms"] = time_ms(g_call, dev, iters=3, warmup=1)
    out["d_step_ms"] = time_ms(d_call, dev, iters=3, warmup=1)
    out["steps_peak_memory_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                                   if dev.type == "cuda" else None)
    vgg = gan.init_vgg19().to(dev)
    a_fake = fake.detach().requires_grad_()
    prep = gan.echoes_to_vgg_input

    def vgg_part():
        with torch.no_grad():
            fa = vgg(prep(batch[0]))
        loss = gan.perceptual_cosine_loss(fa, vgg(prep(a_fake)))
        torch.autograd.grad(loss, a_fake)

    def r1_part():
        r1 = r1_regularization(lambda x: disc(x, update_stats=False),
                               batch[0])
        r1.backward()
        disc.zero_grad()

    g_dev, d_dev = _lstm_devices_ms(g_call, dev), _lstm_devices_ms(d_call,
                                                                    dev)
    vgg_dev, r1_dev = _lstm_devices_ms(vgg_part, dev), _lstm_devices_ms(
        r1_part, dev)
    out["device_ms"] = None if g_dev is None else dict(
        g_step=g_dev["all"], d_step=d_dev["all"],
        g_step_convlstm=g_dev["convlstm"],
        vgg_perceptual_alone=vgg_dev["all"],
        r1_double_backward_alone=r1_dev["all"],
        g_step_idle_share=max(0.0, 1.0 - g_dev["all"] / out["g_step_ms"]),
        d_step_idle_share=max(0.0, 1.0 - d_dev["all"] / out["d_step_ms"]))
    return out


# the float64 envelope of the GAN step gates: where the card is farther
# than the tolerance from the CPU, it passes only if its own distance from
# the float64 witness is within the tolerance or within GAN_ENVELOPE times
# the CPU's (the adversarial g-step's CPU float32 gradient lies 3.06e-2 of
# scale from float64 at 96², past the 2e-2 gate; PERF.md §6, the GAN)
GAN_ENVELOPE = 2.0
# VGG19's perceptual loss (1 − cos of 16 layers of FP32 features) on the
# card: cuDNN's FP32 convolutions put it 2.26e-5 from the float64 witness
# on the same echoes (the CPU 1.5e-7); it is held to this absolute
# tolerance instead of 2e-5 (PERF.md §6, the GAN)
GAN_PERCEPTUAL_TOL = 1e-4
# the bf16 g-step's loss, card vs CPU, in bf16 unit roundoffs of the CPU's
# bf16 loss: the two lie 1.5 u apart at 96² (the bf16 ConvLSTM kernel
# against its plain version alone moves the loss 1.0 u), while the CPU's
# bf16 effect on the loss is 0.19 u, too small for `bf16_step_gate`'s
# loss rule (PERF.md §6, the GAN)
GAN_BF16_LOSS_ULPS = 4.0


def _gan_parity_failures(parity: dict) -> dict:
    """The card-vs-CPU GAN steps past MODEL_PARITY.json's tolerances (loss
    and metrics 2e-5 relative to max(|CPU|, 1), as the CPU parity tests
    hold them: the perceptual loss is 1 − cos, whose own size says nothing
    of its error; gradients 2e-2 of scale) whose card value is also
    outside the float64 envelope: farther from the float64 witness than
    the tolerance and than `GAN_ENVELOPE` times the CPU."""
    out = {}
    for name, v in parity.items():
        def outside(card, cpu, f64, tol):
            # no witness (f64 None) only where the plain tolerance held
            return _loss_gap(card, cpu) > tol and (
                f64 is None or _loss_gap(card, f64) > max(
                    tol, GAN_ENVELOPE * _loss_gap(cpu, f64)))
        bad = []
        if outside(v["loss"], v["loss_ref"], v["loss_f64"], STEP_LOSS_TOL):
            bad.append("loss")
        vs64 = v["vs_cpu_float64"]
        if v["grad_max_rel"] > STEP_GRAD_TOL and (vs64 is None or vs64[
                "card"] > max(STEP_GRAD_TOL, GAN_ENVELOPE * vs64["cpu"])):
            bad.append("gradients")
        bad += [k for k, x in v["metrics"].items()
                if outside(x, v["metrics_ref"][k],
                           (v["metrics_f64"] or {}).get(k),
                           GAN_PERCEPTUAL_TOL if k == "A2B2A_cycle_loss"
                           and "perceptual" in v else STEP_LOSS_TOL)]
        if bad:
            out[name] = bad
    return out


def gan_bf16_gate(run: dict, ref: dict, f32: dict) -> dict:
    """`bf16_step_gate` with its loss rule replaced by |run − ref| ≤
    GAN_BF16_LOSS_ULPS · u · |ref| (the gradient, resolved-leaves and
    bf16-applied rules as they are)."""
    out = bf16_step_gate(run, ref, f32)
    out["loss_ulps"] = out["loss_gap"] / (BF16_U * abs(ref["loss"]))
    out["failures"] = [f for f in out["failures"] if f != "loss"]
    if out["loss_ulps"] > GAN_BF16_LOSS_ULPS:
        out["failures"].insert(0, "loss")
    return out


def _gan_parity_setup(size: int, f: int, d: int = D_GAN):
    """The GAN step parities' inputs: (cfg at the DEFAULTS with the
    adversary, seeded models, the VGG, a trainable copy of the
    discriminator, the g-step's (A, B, te, ε), fixed generated echoes)."""
    import numpy as np
    import torch
    from ideal_gan_tpu_torch.cli.common import synthetic_dataset
    from ideal_gan_tpu_torch.data import mag_phase_maps, maps_from_mebcrn
    from ideal_gan_tpu_torch.train import gan

    cfg = _gan_cfg(size, f, 1, 1, d=d)
    acqs, maps, te = synthetic_dataset(1, h=size, w=size, ne=NE, seed=1)
    b = mag_phase_maps(maps_from_mebcrn(torch.from_numpy(maps)).numpy(),
                       unwrap=True)
    rng = np.random.default_rng(2)
    A, B = (torch.from_numpy((x + 1e-3 * rng.normal(size=x.shape))
                             .astype(np.float32)) for x in (acqs, b))
    lat = size // 2 ** cfg["n_downsamplings"]
    eps = torch.from_numpy(rng.normal(
        size=(1, lat, lat, cfg["encoded_size"])).astype(np.float32))
    fake = torch.from_numpy((acqs * 0.9 + 0.02 * rng.normal(
        size=acqs.shape)).astype(np.float32))
    gen = torch.Generator().manual_seed(5)
    models = gan.build_models(cfg)
    for m in models:
        m.init_params(gen)
    d_model = gan.build_models(cfg).disc
    d_model.load_state_dict(models.disc.state_dict())
    models.disc.requires_grad_(False)  # the g-step's discriminator
    return (cfg, models, gan.init_vgg19(), d_model,
            (A, B, torch.from_numpy(te), eps), fake)


def _gan_g_loss(cfg):
    """make_loss for `_step_run` over (enc, dec_ff, dec_mag, dec_pha, vq,
    disc, vgg): the g-step's loss and metrics."""
    from ideal_gan_tpu_torch.train import gan

    def make(enc, dff, dmag, dpha, vq, disc, vgg):
        fn = gan.make_g_loss_fn(cfg, gan.GANModels(enc, dff, dmag, dpha,
                                                   disc, vq), vgg)
        return lambda *args: fn(*args)[:2]
    return make


def _gan_nets(models, vgg) -> tuple:
    from ideal_gan_tpu_torch.train import gan
    return (*[getattr(models, n) for n in gan.G_NETS], models.disc, vgg)


def gan_step_parity(dev, size: int, f: int, d: int = D_GAN) -> dict:
    """The GAN steps on `dev` (TF32 off) and on the CPU from the same
    weights, batch and noise (`_gan_parity_setup`), each with the CPU's
    float64 witness (the nets in float64, their outputs float32;
    `_parity_of`): the g-step at the JAX `DEFAULTS` with the adversary (VGG
    perceptual cycle, WGAN term; ε passed in) and without it, and the
    d-step (R1 included, on fixed generated echoes). The bf16 g-step
    (without the adversary: with it the bf16 gradient is rounding noise,
    card and CPU 0.91 of scale apart and no leaf resolved; PERF.md §6,
    the GAN) card vs CPU within `bf16_step_gate`, the CPU's float32 step the
    witness, with its three controls (`gan_bf16_gate`: its loss rule in
    bf16 ulps). The echoes and maps carry N(0, 1e-3²) noise, so that no
    input has an exactly zero background."""
    import torch
    from ideal_gan_tpu_torch.train import gan

    cpu = torch.device("cpu")
    cfg, models, vgg, d_model, args, fake = _gan_parity_setup(size, f, d)

    def runs(make, nets, args):
        return [_step_run(make, nets, args, where, dtype) for where, dtype
                in ((dev, None), (cpu, None), (cpu, torch.float64))]

    cfg0 = dict(cfg, adv_train=False)
    nets = _gan_nets(models, vgg)
    plain = runs(_gan_g_loss(cfg0), nets, args)
    out = {"g_step": _parity_of(*runs(_gan_g_loss(cfg), nets, args)),
           "g_step_no_adversary": _parity_of(*plain),
           "d_step": _parity_of(*runs(lambda d: gan.make_d_loss_fn(cfg, d),
                                      (d_model,), (args[0], fake)))}
    models16 = gan.build_models(dict(cfg0, bf16=True))
    for a, b in zip(models16, models):
        a.load_state_dict(b.state_dict())
    make16 = _gan_g_loss(dict(cfg0, bf16=True))
    card = _step_run(make16, _gan_nets(models16, vgg), args, dev)
    ref = _step_run(make16, _gan_nets(models16, vgg), args, cpu)
    for name in ("g_step", "g_step_no_adversary"):
        out[name]["perceptual"] = cfg["A_loss"] == "VGG"
    f32 = plain[1]
    res = gan_bf16_gate(card, ref, f32)
    res["metrics"], res["metrics_ref"] = card["metrics"], ref["metrics"]
    res["metrics_f32"] = f32["metrics"]
    g = card["grads"]
    controls = {"f32_step": f32,
                "zero_gradient": dict(card, grads={
                    k: torch.zeros_like(v) for k, v in g.items()}),
                "flipped_gradient": dict(card, grads={
                    k: -v for k, v in g.items()})}
    res["controls"] = {name: gan_bf16_gate(c, ref, f32)["failures"]
                       for name, c in controls.items()}
    res["controls_fail"] = all(res["controls"].values())
    out["bf16_g_step_no_adversary"] = res
    return out


def gan_phase(dev, out_dir: Path, size: int = GAN_SIZE, f: int = F_MAIN,
              n: int = 16, epochs: int = 2, n_short: int = 4,
              parity_size: int = 96, d: int = D_GAN) -> dict:
    """`cli.train_gan` at the JAX `DEFAULTS` with the adversary (F=36, 4
    levels, latent 258, PatchGAN 72 with self-attention, VGG perceptual
    cycle; batch 1, `n` synthetic `size`² slices, `epochs` epochs), counted
    and timed (`gan_run`); then one short epoch (`n_short` slices) each
    with `--VQ_encoder 1`, `--cGAN 1` and `--bf16 1`; then the card-vs-CPU
    steps at `parity_size`² (`gan_step_parity`, TF32 off). `f` and `d` are
    the generator's and the PatchGAN's widths."""
    main = gan_run(dev, out_dir, "gan", size, f, n, epochs, timed=True, d=d)
    short = {k: gan_run(dev, out_dir, f"gan_{k}", size, f, n_short, 1, over,
                        d=d) for k, over in GAN_SHORT.items()}
    set_tf32(False)
    parity = gan_step_parity(dev, parity_size, f, d)
    set_tf32(True)
    return dict(launches=main["launches"], main=main, short=short,
                parity=parity, parity_shape=dict(size=parity_size, batch=1,
                                                 F=f, D=d))


def check_gan(g: dict) -> None:
    """The gan phase's gates, for the main run and each short one: the
    ConvLSTM kernels of the run's dtype (f32, or bf16 under `--bf16`)
    launched as often as one g-step launches them times the g-steps, at
    least once an echo, and never by a d-step (the run's totals equal the
    g-steps' alone, and the d-step counted alone launches none), the other
    dtype's never; every loss and metric finite; every encoder ConvLSTM
    parameter with a non-zero gradient; the discriminator's u changed by
    the run and by a d-step, and not by a g-step. Then the card-vs-CPU g-
    steps (with and without the adversary) and d-step
    (`_gan_parity_failures`: the tolerances of `_parity_failures`, or the
    float64 envelope) and the bf16 g-step within `gan_bf16_gate`, whose
    three controls fail it."""
    for name, r in {"main": g["main"], **g["short"]}.items():
        lstm, other = GAN_LSTM[r["bf16"]], GAN_LSTM[not r["bf16"]]
        per = r["g_step_launches"]
        bad = [k for k in lstm if per[k] < NE
               or r["launches"][k] != r["g_steps"] * per[k]
               or r["d_step_launches"][k]]
        bad += [k for k in other if r["launches"][k] or per[k]]
        if bad:
            raise AssertionError(
                f"gan {name}: ConvLSTM kernels not on every g-step only: "
                f"{bad} (run {r['launches']}, g-step {per}, d-step "
                f"{r['d_step_launches']}, {r['g_steps']} g-steps)")
        if not r["finite"] or r["no_gradient"]:
            raise AssertionError(f"gan {name}: non-finite metrics or "
                                 f"ConvLSTM parameters without a gradient: "
                                 f"{r['epochs']}, {r['no_gradient']}")
        if not r["u_changed_by_run"] or not r["u_changed_by_d_step"] \
                or r["u_changed_by_g_step"]:
            raise AssertionError(
                f"gan {name}: the spectral-norm u must change on d-steps "
                f"only: run {r['u_changed_by_run']}, g-step "
                f"{r['u_changed_by_g_step']}, d-step "
                f"{r['u_changed_by_d_step']}")
    par = g["parity"]
    bad = _gan_parity_failures({k: par[k] for k in (
        "g_step", "g_step_no_adversary", "d_step")})
    if bad:
        raise AssertionError(f"card and CPU GAN steps disagree beyond "
                             f"float32's envelope: {bad}")
    b = par["bf16_g_step_no_adversary"]
    if b["failures"] or not b["controls_fail"]:
        raise AssertionError(f"the bf16 GAN g-step fails bf16_step_gate, or "
                             f"a control passes it: {b}")


# the ldm phase: the LDM CLIs at the LDM DEFAULTS (T=200, F=64, dim_mults
# (1, 2, 4), batch 8) on the gan phase's card-trained runs, whose latent at
# the GAN DEFAULTS is (12, 12, 258) for 192² echoes
LDM_LAT, LDM_CHANNELS = GAN_SIZE // 16, 258
# the 50-step DDIM chain card vs CPU: the card's float32 chain no farther
# from the float64 chain than this many times the CPU's
LDM_CHAIN_ENVELOPE = 2.0
# without class conditioning the class planes' Dense kernels see zero
# embeddings: no gradient reaches them (in JAX as here)
LDM_CLASS_KERNELS = "cond.dense.weight"


def _ldm_flags(dev, exp_dir: Path, out_dir: Path, name: str, flags=()):
    return ["--experiment_dir", str(exp_dir), "--dataset", name,
            "--output_base", str(out_dir), "--device", str(dev), "--seed",
            "0", *flags]


def ldm_train_run(dev, out_dir: Path, exp_dir: Path, name: str, n: int,
                  epochs: int, batch: int = 8, flags=(),
                  timed: bool = False) -> dict:
    """`cli.train_ldm.main` on the GAN run `exp_dir` (`n` of its synthetic
    slices, `epochs` epochs at `batch`), counted: its launches beside the
    encodes it makes (the z_std pass, the `in_res` probe, one a step), z_std
    beside its float64 recomputation over the cohort encoded again in the
    same batches (the encoder's kernels are deterministic), the
    checkpoint's z_std, the denoiser's parameters without a gradient after
    the last step. With `timed`: ms per step (the batch's encode, the
    normalization and the step) and per denoiser call at `batch` under
    `no_grad` (CUDA events), their device ms and idle shares, and the
    encode's (the ConvLSTM forward kernel's six launches alone too)."""
    import torch
    from ideal_gan_tpu_torch.cli import train_ldm
    from ideal_gan_tpu_torch.cli.common import load_cohorts, load_settings
    from ideal_gan_tpu_torch.train import gan, ldm
    from ideal_gan_tpu_torch.utils import Checkpoint

    argv = _ldm_flags(dev, exp_dir, out_dir, name, (
        "--synthetic", str(n), "--epochs", str(epochs), "--epoch_ckpt",
        str(epochs), "--batch_size", str(batch), *flags))
    result, wall, launches, peak = counted_peak(dev,
                                                lambda: train_ldm.main(argv))
    state = result["state"]
    steps = n // batch * epochs
    gan_cfg = load_settings(exp_dir).backfill(gan.DEFAULTS)
    models = ldm.load_gan(gan_cfg, exp_dir, dev)
    encode = ldm.make_encode(models, gan_cfg["VQ_encoder"])
    acqs, _, _ = load_cohorts(gan_cfg.overlay({"synthetic": n}))
    lat = torch.cat([encode(torch.from_numpy(acqs[i:i + batch]).to(dev))
                     for i in range(0, n, batch)]).double()
    z_std64 = float(torch.sqrt(torch.mean(torch.square(lat - lat.mean()))))
    zero_class = [k for k, p in state.model.named_parameters()
                  if k.endswith(LDM_CLASS_KERNELS)
                  and state.model.embed is None]
    out = dict(launches=launches, steps=steps,
               encodes=-(-n // batch) + 1 + steps, wall_s=wall,
               peak_memory_gb=peak, epochs=result["epochs"],
               finite=_finite_losses(result["epochs"]),
               z_std=result["z_std"], z_std_f64=z_std64,
               z_std_rel_diff=abs(result["z_std"] - z_std64) / z_std64,
               checkpoint_z_std=Checkpoint(
                   Path(exp_dir) / "checkpoints_ldm").restore().get("z_std"),
               no_gradient=[k for k in _no_gradient(state.model, ("",))
                            if k not in zero_class],
               class_kernels_without_gradient=len(zero_class),
               class_kernels_zero=all(
                   not bool(p.grad.abs().max() > 0)
                   for k, p in state.model.named_parameters()
                   if k in zero_class),
               bf16=bool(gan_cfg["bf16"]))
    if not timed:
        return out
    A = torch.from_numpy(acqs[:batch]).to(dev)
    labels = torch.zeros((batch,), dtype=torch.long, device=dev)
    step_fn, _ = ldm.make_train_step(
        dict(ldm.DEFAULTS, epochs=epochs), state.model,
        ldm.build_schedule(ldm.DEFAULTS),
        torch.Generator(device=dev).manual_seed(1))
    x = torch.randn((batch, *lat.shape[1:]), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    t = torch.full((batch,), 100, dtype=torch.long, device=dev)

    def step():
        step_fn(state, (encode(A) / state.z_std, labels))

    @torch.no_grad()
    def denoise():
        state.model(x, t, labels)

    split = {"all": "", "convlstm_fwd": LSTM_FWD}
    out.update(step_ms=time_ms(step, dev, iters=3, warmup=1),
               denoiser_ms=time_ms(denoise, dev, iters=20, warmup=2),
               encode_ms=time_ms(lambda: encode(A), dev, iters=5))
    dev_ms = {k: device_ms_by(fn, dev, split) for k, fn in (
        ("step", step), ("denoiser", denoise), ("encode", lambda: encode(A)))}
    out["device_ms"] = None if dev_ms["step"] is None else dict(
        **{f"{k}_{part}": v[part] for k, v in dev_ms.items()
           for part in ("all", "convlstm_fwd")},
        **{f"{k}_idle_share": max(0.0, 1.0 - dev_ms[k]["all"]
                                  / out[f"{k}_ms"])
           for k in ("step", "denoiser", "encode")})
    return out


def ldm_gen_run(dev, out_dir: Path, exp_dir: Path, n: int, batch: int,
                size: int, flags=()) -> dict:
    """`cli.gen_ldm_dataset.main --write_dicom 1` (DDPM, the full T-step
    chain) on the LDM of `exp_dir`, counted; its shards read back: shapes,
    finiteness and the seconds of each batch; every volume's PDFF, R2s and
    MultiEcho file read back against the shards (`readback_mismatches`)."""
    import numpy as np
    from ideal_gan_tpu_torch.cli import gen_ldm_dataset
    from ideal_gan_tpu_torch.data.records import read_shards
    from ideal_gan_tpu_torch.eval.roi import maps_to_display

    argv = _ldm_flags(dev, exp_dir, out_dir, "ldm_gen", (
        "--n_samples", str(n), "--sample_batch", str(batch), "--method",
        "ddpm", "--write_dicom", "1", *flags))
    result, wall, launches = counted(dev, lambda: gen_ldm_dataset.main(argv))
    acqs, maps = read_shards(result["shards"])
    readback = readback_mismatches(
        Path(out_dir) / "ldm_gen" / "generated" / "out_dicom",
        {("PDFF", "PDFF_s00.dcm"): maps_to_display(maps)[0],
         ("R2s", "R2s_s00.dcm"): maps[:, 2, ..., 1],
         ("MultiEcho", "ME_s00.dcm"): np.hypot(acqs[:, 0, ..., 0],
                                               acqs[:, 0, ..., 1])})
    return dict(launches=launches, wall_s=wall, shards=len(result["shards"]),
                readback=readback,
                seconds_per_batch=result["seconds"],
                acqs_shape=list(acqs.shape), maps_shape=list(maps.shape),
                shapes_ok=acqs.shape == (n, NE, size, size, 2)
                and maps.shape == (n, 3, size, size, 2),
                finite=bool(np.isfinite(acqs).all()
                            and np.isfinite(maps).all()))


def ldm_metrics_run(dev, out_dir: Path, exp_dir: Path, n: int,
                    flags=()) -> dict:
    """`cli.test_genmetrics.main --use_ldm 1` (DDIM, 50 steps) on the LDM of
    `exp_dir` and `n` real slices, counted."""
    from ideal_gan_tpu_torch.cli import test_genmetrics

    argv = _ldm_flags(dev, exp_dir, out_dir, "ldm_metrics", (
        "--synthetic", str(n), "--n_samples", str(n), "--use_ldm", "1",
        *flags))
    result, wall, launches = counted(dev, lambda: test_genmetrics.main(argv))
    values = [v for v in result.values() if isinstance(v, float)]
    return dict(launches=launches, wall_s=wall, results=result,
                finite=all(math.isfinite(v) for v in values))


def ldm_step_parity(dev, cfg: dict, channels: int, lat: int,
                    batch: int = 2) -> dict:
    """The LDM on `dev` (TF32 off) and on the CPU from the same seeded
    denoiser (`cfg`, `channels` × `lat`²) and inputs: the ε-MSE step (loss,
    every gradient leaf) with the CPU's float64 witness (`_parity_of`); one
    DDPM and one DDIM reverse step at t = T·3/5 on identical inputs; and
    the `infer_steps` DDIM chain (`train.ldm.sample_latents`) on identical
    noise, each device's float32 chain and the CPU's float64 one."""
    import copy

    import numpy as np
    import torch
    from ideal_gan_tpu_torch import diffusion
    from ideal_gan_tpu_torch.train import ldm

    cpu = torch.device("cpu")
    model = ldm.build_model(cfg, channels)
    model.init_params(torch.Generator().manual_seed(5))
    sched = ldm.build_schedule(cfg)
    rng = np.random.default_rng(3)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    shape = (batch, lat, lat, channels)
    z, noise = normal(*shape), normal(*shape)
    t = torch.from_numpy(rng.integers(0, cfg["n_timesteps"], batch))
    labels = torch.zeros((batch,), dtype=torch.long)

    def make(m):
        loss_fn = ldm.make_loss_fn(m, sched)

        def fn(*args):
            loss = loss_fn(*args)
            return loss, {"loss": loss}
        return fn

    out = {"step": _parity_of(*[
        _step_run(make, (model,), (z, labels, t, noise), where, dtype)
        for where, dtype in ((dev, None), (cpu, None), (cpu, torch.float64))])}
    x, eps, zz = normal(*shape), normal(*shape), normal(*shape)
    t_rev = cfg["n_timesteps"] * 3 // 5

    def reverse(where):
        s = sched.to(where)
        a, e, r = (v.to(where) for v in (x, eps, zz))
        return (diffusion.ddpm_reverse_step(a, e, t_rev, s, r).cpu(),
                diffusion.ddim_reverse_step(a, e, t_rev, 0.0, s, r).cpu())

    card, ref = reverse(dev), reverse(cpu)
    out["reverse_steps"] = {"ddpm": _rel(card[0], ref[0]),
                            "ddim": _rel(card[1], ref[1])}
    x_init = normal(*shape)
    zs = [normal(*shape) for _ in range(cfg["infer_steps"])]

    def chain(where, dtype=torch.float32):
        m = copy.deepcopy(model).to(where, dtype)
        return ldm.sample_latents(
            cfg, m, sched, batch, (lat, lat), channels, 1.0, method="ddim",
            x_init=x_init.to(where, dtype),
            zs=[v.to(where, dtype) for v in zs]).cpu().double()

    c, p, w = chain(dev), chain(cpu), chain(cpu, torch.float64)
    out["ddim_chain"] = dict(steps=cfg["infer_steps"],
                             card_vs_cpu=_rel(c, p), card_vs_f64=_rel(c, w),
                             cpu_vs_f64=_rel(p, w),
                             finite=bool(torch.isfinite(c).all()))
    return out


def ldm_phase(dev, out_dir: Path, gan_dir: Path, gan_bf16_dir: Path,
              n: int = 16, epochs: int = 2, batch: int = 8,
              n_samples: int = 16, size: int = GAN_SIZE, flags=(),
              parity_cfg: dict | None = None, lat: int = LDM_LAT,
              channels: int = LDM_CHANNELS) -> dict:
    """The LDM family on the gan phase's runs: `cli.train_ldm` at the LDM
    `DEFAULTS` on the f32 GAN run (`n` slices, `epochs` epochs at `batch`),
    counted and timed (`ldm_train_run`); `cli.gen_ldm_dataset` (`n_samples`
    in batches of `batch`, the full DDPM chain) and `cli.test_genmetrics
    --use_ldm 1` on it; one epoch of `train_ldm` on the bf16 GAN run (`batch`
    slices); then the card-vs-CPU step, reverse steps and DDIM chain at
    the LDM `DEFAULTS` (`ldm_step_parity`, TF32 off). `flags` go to every
    CLI (the rehearsal's tiny sizes), `parity_cfg` overrides the DEFAULTS
    of the parity."""
    from ideal_gan_tpu_torch.train import ldm
    main = ldm_train_run(dev, out_dir, gan_dir, "ldm", n, epochs, batch,
                         flags, timed=True)
    gen = ldm_gen_run(dev, out_dir, gan_dir, n_samples, batch, size, flags)
    metrics = ldm_metrics_run(dev, out_dir, gan_dir, n, flags)
    bf16 = ldm_train_run(dev, out_dir, gan_bf16_dir, "ldm_bf16", batch, 1,
                         batch, flags)
    set_tf32(False)
    cfg = dict(ldm.DEFAULTS, **{"in_res": lat, "infer_steps": 50,
                                **(parity_cfg or {})})
    parity = ldm_step_parity(dev, cfg, channels, lat)
    set_tf32(True)
    return dict(launches=main["launches"], main=main, gen=gen,
                metrics=metrics, bf16=bf16, parity=parity,
                parity_shape=dict(F=cfg["n_ldm_filters"],
                                  dim_mults=list(cfg["dim_mults"]), lat=lat,
                                  channels=channels, batch=2,
                                  ddim_steps=cfg["infer_steps"]))


def check_ldm(r: dict) -> None:
    """The ldm phase's gates: the frozen encoder's ConvLSTM forward kernel
    of the GAN run's dtype launched 6 times an encode (the z_std pass, the
    probe, every step) and the backward never, on every LDM path (sampling
    and the metrics encode nothing); z_std within 1e-6 of its float64
    recomputation and in the checkpoint; every loss finite; every denoiser
    parameter with a non-zero gradient but the class planes' Dense kernels
    without classes, whose gradient is exactly zero; the shards' shapes and
    finiteness; FID, MMD, SSIM and MS-SSIM finite; the card-vs-CPU step
    inside `_gan_parity_failures`' rule, the reverse steps within 1e-5 of
    scale, and the DDIM chain no farther from float64 than
    `LDM_CHAIN_ENVELOPE` times the CPU's."""
    for name in ("main", "bf16"):
        run = r[name]
        fwd, bwd = GAN_LSTM[run["bf16"]]
        other = GAN_LSTM[not run["bf16"]]
        lau = run["launches"]
        if lau[fwd] != NE * run["encodes"] or lau[bwd] or any(
                lau[k] for k in other):
            raise AssertionError(
                f"ldm {name}: the encoder's ConvLSTM forward must launch "
                f"{NE} times an encode ({run['encodes']} encodes) and the "
                f"backward never: {lau}")
        if run["z_std_rel_diff"] > 1e-6 or \
                run["checkpoint_z_std"] != run["z_std"]:
            raise AssertionError(
                f"ldm {name}: z_std {run['z_std']} vs float64 "
                f"{run['z_std_f64']}, checkpoint {run['checkpoint_z_std']}")
        if not run["finite"] or run["no_gradient"] \
                or not run["class_kernels_zero"]:
            raise AssertionError(
                f"ldm {name}: non-finite losses or denoiser parameters "
                f"without a gradient: {run['epochs']}, {run['no_gradient']},"
                f" class kernels zero {run['class_kernels_zero']}")
    for name in ("gen", "metrics"):
        if any(v for k, v in r[name]["launches"].items()
               if k.startswith("convlstm")):
            raise AssertionError(f"ldm {name} ran the encoder: "
                                 f"{r[name]['launches']}")
    gen = r["gen"]
    if any(gen["readback"]["mismatched_pixels"].values()):
        raise AssertionError(f"ldm --write_dicom read back: "
                             f"{gen['readback']}")
    if not gen["shapes_ok"] or not gen["finite"]:
        raise AssertionError(f"ldm shards: {gen['acqs_shape']}, "
                             f"{gen['maps_shape']}, finite {gen['finite']}")
    res = r["metrics"]["results"]
    if not r["metrics"]["finite"] or not {
            "FID", "MMD", "SSIM_pairs", "MS_SSIM_pairs"} <= set(res):
        raise AssertionError(f"ldm metrics missing or not finite: {res}")
    par = r["parity"]
    bad = _gan_parity_failures({"step": par["step"]})
    bad.update({k: v for k, v in par["reverse_steps"].items() if v > 1e-5})
    ch = par["ddim_chain"]
    if not ch["finite"] or ch["card_vs_f64"] > LDM_CHAIN_ENVELOPE * \
            ch["cpu_vs_f64"]:
        bad["ddim_chain"] = ch
    if bad:
        raise AssertionError(f"card and CPU LDM disagree: {bad}")


# the io phase's synthetic scanner files: magnitudes stored as
# rint(|S|·slope) with a 4-significant-digit slope putting the cohort's
# largest magnitude at ~4000, phases as rint(φ·1000 + 4000) (Philips
# private rescale: value = (stored − intercept) / slope)
IO_MAG_TOP = 4000.0
IO_PHASE_SLOPE, IO_PHASE_INTERCEPT = 1000.0, 4000.0
IO_SLICE_MM = 2.5


def write_mecse_folder(folder: Path, subject: int, echoes, te,
                       mag_slope: float) -> int:
    """One subject's MECSE DICOM series, built with the port's
    `DicomDataset` as the JAX package's tests build theirs: a magnitude and
    a phase file per slice and echo of `echoes` (complex (n_slices, ne, H,
    W)), echo numbers from 1, the slice at z = 2.5 mm·k, the private
    component (2005,1011) and rescale (2005,100D/E) tags. Returns the
    files written."""
    import numpy as np
    from ideal_gan_tpu_torch.data import dicom

    folder.mkdir(parents=True, exist_ok=True)
    n_sl, ne, h, w = echoes.shape
    stored = {
        "M": (np.rint(np.abs(echoes) * mag_slope), "0.0",
              repr(float(mag_slope))),
        "P": (np.rint(np.angle(echoes) * IO_PHASE_SLOPE
                      + IO_PHASE_INTERCEPT),
              repr(IO_PHASE_INTERCEPT), repr(IO_PHASE_SLOPE))}
    for k in range(n_sl):
        for e in range(ne):
            for comp, (img, intercept, slope) in stored.items():
                ds = dicom.gen_ds(subject)
                ds[(0x2005, 0x1011)] = ("LO", comp)
                ds.EchoNumbers = e + 1
                ds.EchoTrainLength = ne
                ds.EchoTime = f"{float(te[e]) * 1e3:.3f}"
                ds.ImagePositionPatient = f"0\\0\\{IO_SLICE_MM * k:.1f}"
                ds[(0x2005, 0x100D)] = ("DS", intercept)
                ds[(0x2005, 0x100E)] = ("DS", slope)
                ds.Columns = w
                ds.Rows = h
                ds.PixelData = img[k, e].astype(np.uint16).tobytes()
                ds.save_as(folder / f"IM_s{k:03d}_e{e:02d}_{comp}.dcm")
    return 2 * n_sl * ne


def write_bids_folder(folder: Path, name: str, echoes, te,
                      compresslevel: int = 1) -> None:
    """One subject's BIDS multi-echo set: `<name>_e{n}.nii.gz` magnitude
    and `<name>_e{n}_ph.nii.gz` phase volumes (x = W, y = H flipped, z =
    slice, the orientation `load_nifti_series` transposes and flips back)
    with `<name>_e{n}.json` sidecars."""
    import numpy as np
    from ideal_gan_tpu_torch.data import nifti

    folder.mkdir(parents=True, exist_ok=True)
    ne = echoes.shape[1]
    for e in range(ne):
        vol = echoes[:, e, ::-1, :].transpose(2, 1, 0)
        base = folder / f"{name}_e{e + 1}"
        nifti.write_nifti(f"{base}.nii.gz", np.abs(vol), compresslevel)
        nifti.write_nifti(f"{base}_ph.nii.gz", np.angle(vol), compresslevel)
        (folder / f"{name}_e{e + 1}.json").write_text(json.dumps(
            {"EchoTrainLength": ne, "EchoTime": float(te[e]) * 1e3}))


def dicom_quantisation_bound(peak: float, mag_slope: float) -> float:
    """The loader's largest distance from the source echoes over their
    largest magnitude M: magnitudes within δm = ½/slope, the global
    normalisation's denominator within δm of M, phases within δφ =
    ½/1000, so |x̂ − x/M| ≤ 2δm/(M − δm) + δφ; 2e-6 more for float32."""
    dm, dphi = 0.5 / mag_slope, 0.5 / IO_PHASE_SLOPE
    return 2 * dm / (peak - dm) + dphi + 2e-6


def nifti_expected(echoes):
    """What `load_nifti_series(half_echoes=False)` must return for
    `write_bids_folder`'s files of `echoes`: the float32 magnitude·e^{i·φ}
    over the first echo's largest magnitude, zero where the mean
    magnitude over the echoes is < 0.05. (n_slices, ne, H, W, 2)."""
    import numpy as np
    mag = np.abs(echoes).astype(np.float32)
    pha = np.angle(echoes).astype(np.float32)
    x = mag * np.exp(1j * pha) / float(mag[:, 0].max())
    keep = np.abs(x).mean(axis=1, keepdims=True) >= 0.05
    x = np.where(keep, x, 0)
    return np.stack([x.real, x.imag], -1).astype(np.float32)


def readback_mismatches(dicom_dir: Path, planes: dict) -> dict:
    """Pixels of `<dicom_dir>/Volunteer-NNN/<series>/<file>` read back with
    the port's reader that differ from uint16(255·clip(plane[NNN], 0, 1)),
    for each (series, file) → plane in `planes`; with the files read."""
    import numpy as np
    from ideal_gan_tpu_torch.data import dicom
    bad, files = {}, 0
    for (series, fname), stack in planes.items():
        n = 0
        for j in range(len(stack)):
            path = dicom_dir / f"Volunteer-{j:03d}" / series / fname
            got = dicom.pixel_array(dicom.read_dicom(str(path)))
            want = (np.clip(stack[j], 0, 1) * 255).astype(np.uint16)
            n += int((got != want).sum()) if got.shape == want.shape \
                else got.size + want.size
            files += 1
        bad[series] = n
    return dict(mismatched_pixels=bad, files=files)


def _timed(loader, items) -> tuple[list, list]:
    """`loader` on each of `items`: (its results, its host seconds)."""
    out, secs = [], []
    for f in items:
        t0 = time.perf_counter()
        out.append(loader(str(f)))
        secs.append(time.perf_counter() - t0)
    return out, secs


def parse_seconds(files) -> dict:
    """The host seconds over `files` of reading their bytes alone, of the
    Python tag walk (`read_dicom`) and of the native parser: what the
    JAX docstring's "~20× faster" compares."""
    from ideal_gan_tpu_torch.data import dicom, dicom_native

    def read(f):
        with open(f, "rb") as fh:
            fh.read()

    return {name: sum(_timed(fn, files)[1]) for name, fn in (
        ("read_bytes", read), ("python", dicom.read_dicom),
        ("native", dicom_native.parse_dicom_native))}


def io_train_run(dev, out_dir: Path, data_dir: Path, kind: str, loader,
                 size: int, batch: int, f: int, flags=()) -> dict:
    """`cli.train_unsup --train_data <kind>` on the subject folders of
    `data_dir` for one epoch at `batch`, counted: its launches, finite
    losses, and the cohort it trained on against `loader`'s own output of
    the sorted folders (bit for bit) and the 1.5 T TE train."""
    import numpy as np
    from ideal_gan_tpu_torch import physics
    from ideal_gan_tpu_torch.cli import train_unsup

    argv = ["--train_data", kind, "--dataset_dir", str(data_dir),
            "--dataset", f"io-{kind.lower()}", "--data_size", str(size),
            "--batch_size", str(batch), "--epochs", "1", "--out_vars", "PM",
            "--n_G_filters", str(f), "--seed", "0", "--device", str(dev),
            "--output_base", str(out_dir), *flags]
    result, wall, launches = counted(dev, lambda: train_unsup.main(argv))
    acqs, te = result["cohort"]
    own = np.concatenate([loader(str(p)) for p in sorted(data_dir.iterdir())])
    te_ref = physics.te_train(own.shape[1], bs=len(own)).numpy()
    return dict(launches=launches, wall_s=wall, epochs=result["epochs"],
                steps=result["epochs"][-1]["steps"] if result["epochs"]
                else 0, finite=_finite_losses(result["epochs"]),
                cohort_shape=list(acqs.shape),
                cohort_equal=bool(acqs.dtype == own.dtype
                                  and np.array_equal(acqs, own)),
                te_equal=bool(np.array_equal(te, te_ref)),
                experiment_dir=str(Path(out_dir) / f"io-{kind.lower()}"))


def io_phase(dev, out_dir: Path, size: int = SIZE, subjects: int = 2,
             slices: int = 8, batch: int = NB_SERVE, f: int = F_MAIN,
             flags=()) -> dict:
    """Scanner files in and out at full size: a synthetic cohort
    (`synthetic_dataset`, `subjects`·`slices` slices at `size`², 12 echoes)
    written as MECSE DICOM series folders (its first 6 echoes, magnitude
    and phase) and BIDS NIfTI sets (all 12); the DICOM loader's native and
    Python walks on every folder (bit-equal, within
    `dicom_quantisation_bound` of the source, host seconds each), the
    NIfTI loader against `nifti_expected`; `cli.train_unsup` from each kind
    of folder (`io_train_run`); `cli.infer --model_sel AI-DEAL --export
    dicom,npz` on the DICOM run, every PDFF and R2s file read back against
    the npz maps (`readback_mismatches`); then item 9's physics card
    against CPU (`physics_card_vs_cpu`). `flags` go to both CLIs (the
    rehearsal's tiny widths)."""
    import numpy as np
    import torch
    from ideal_gan_tpu_torch.cli import infer
    from ideal_gan_tpu_torch.cli.common import synthetic_dataset
    from ideal_gan_tpu_torch.data import dicom, dicom_native, nifti

    t0 = time.perf_counter()
    acqs, _, te = synthetic_dataset(subjects * slices, size, size, ne=2 * NE,
                                    seed=0)
    echoes = (acqs[..., 0] + 1j * acqs[..., 1]).astype(np.complex64)
    peak = float(np.abs(echoes[:, :NE]).max())
    mag_slope = float(f"{IO_MAG_TOP / peak:.4g}")
    dcm_root, nii_root = out_dir / "dicom", out_dir / "nifti"
    files = 0
    for s in range(subjects):
        sub = slice(s * slices, (s + 1) * slices)
        files += write_mecse_folder(dcm_root / f"sub-{s:02d}", s,
                                    echoes[sub, :NE], te[0, :NE, 0],
                                    mag_slope)
        write_bids_folder(nii_root / f"sub-{s:02d}", f"sub-{s:02d}",
                          echoes[sub], te[0, :, 0])
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    folders = sorted(dcm_root.iterdir())
    built = dicom_native.native_available()  # builds the parser: untimed
    dicom.load_dicom_series(str(folders[0]))
    auto_backend = dicom.LAST_BACKEND
    loaded, secs = {}, {}
    for b in ("native", "python"):
        loaded[b], secs[b] = _timed(
            lambda p, b=b: dicom.load_dicom_series(p, b), folders)
    native, python = loaded["native"], loaded["python"]
    parse = parse_seconds(dicom.series_files(str(folders[0])))
    quant = 0.0
    for s, got in enumerate(native):
        src = echoes[s * slices:(s + 1) * slices, :NE]
        ref = src / np.abs(src).max()
        quant = max(quant, float(np.abs(
            got[..., 0] + 1j * got[..., 1] - ref).max()))
    nii_err = 0.0
    for s, p in enumerate(sorted(nii_root.iterdir())):
        got = nifti.load_nifti_series(str(p), half_echoes=False)
        want = nifti_expected(echoes[s * slices:(s + 1) * slices])
        nii_err = max(nii_err, float(np.abs(got - want).max())
                      if got.shape == want.shape else math.inf)
    loaders = dict(
        files=files, write_s=write_s, native_built=built,
        auto_backend=auto_backend,
        native_equal_python=all(
            a.dtype == b.dtype and np.array_equal(a, b)
            for a, b in zip(native, python)),
        shape=list(native[0].shape), mag_slope=mag_slope,
        quantisation_max_err=quant,
        quantisation_bound=dicom_quantisation_bound(peak, mag_slope),
        nifti_max_err=nii_err, seconds_per_folder=secs,
        files_per_folder=files // subjects,
        native_speedup=sum(secs["python"]) / max(sum(secs["native"]), 1e-9),
        parse_seconds_per_folder=parse,
        parse_speedup=parse["python"] / max(parse["native"], 1e-9),
        seconds=time.perf_counter() - t0)
    runs = {kind: io_train_run(dev, out_dir, root, kind, loader, size, batch,
                               f, flags)
            for kind, root, loader in (
                ("DICOM", dcm_root, dicom.load_dicom_series),
                ("NIFTI", nii_root, nifti.load_nifti_series))}
    argv = ["--model_sel", "AI-DEAL", "--experiment_dir",
            runs["DICOM"]["experiment_dir"], "--synthetic",
            str(subjects * slices), "--data_size", str(size),
            "--infer_batch", str(batch), "--export", "dicom,npz",
            "--dataset", "io-infer", "--device", str(dev), "--output_base",
            str(out_dir), *flags]
    maps, wall, launches = counted(dev, lambda: infer.main(argv))
    served = out_dir / "io-infer"
    with np.load(served / "maps_pred.npz") as npz:
        readback = readback_mismatches(
            served / "out_dicom", {("PDFF", "PDFF_s00.dcm"): npz["pdff"],
                                   ("R2s", "R2s_s00.dcm"):
                                   npz["maps"][:, 2, ..., 1]})
    infer_run = dict(launches=launches, wall_s=wall, readback=readback,
                     finite=bool(np.isfinite(maps).all()))
    set_tf32(False)
    t0 = time.perf_counter()
    physics = physics_card_vs_cpu(dev, size // 2)
    physics["seconds"] = time.perf_counter() - t0
    set_tf32(True)
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    return dict(loaders=loaders, train_dicom=runs["DICOM"],
                train_nifti=runs["NIFTI"], infer=infer_run, physics=physics,
                shape=dict(subjects=subjects, slices=slices, size=size,
                           echoes_dicom=NE, echoes_nifti=2 * NE, batch=batch,
                           F=f))


IO_PHYSICS_TOL = (1e-5, 1e-4)  # atol, rtol: the kernels phase's fit gate


def physics_card_vs_cpu(dev, size: int = SIZE, nb: int = 2) -> dict:
    """Item 9's physics on `dev` and on the CPU from the same inputs (TF32
    off): the bipolar synthesis → fit round trip (4 map rows; the fit's
    (φ, R2*) row first and the bipolar row last, > 3 rows), `acq_demod`,
    `fa_cycle`, `fa_forward`, `fa_get_rho` (12 echoes) and
    `compat.acq_to_acq` and `compat.get_rho` with the legacy layout. Each
    output: the count of elements beyond 1e-5 + 1e-4·|CPU| and the largest
    gap over that allowance; the round trip's distance from the truth."""
    import numpy as np
    import torch
    from ideal_gan_tpu_torch import compat, physics
    from ideal_gan_tpu_torch.data import layouts

    rng = np.random.default_rng(9)
    shape = (nb, size, size)

    def cplx(lo, hi):
        return (rng.uniform(lo, hi, shape)
                * np.exp(1j * rng.uniform(-1, 1, shape)))

    def pair(z):
        return np.stack([z.real, z.imag], -1)

    phi = rng.uniform(-0.3, 0.3, shape)
    r2s = rng.uniform(0.0, 0.5, shape)
    bip = np.stack([rng.uniform(-0.2, 0.2, shape), np.zeros(shape)], -1)
    maps = np.stack([pair(cplx(0.1, 0.7)), pair(cplx(0.0, 0.5)),
                     np.stack([phi, r2s], -1), bip], 1).astype(np.float32)
    ns = physics.FATTY_ACID_9PEAK.n_species
    fa_rho = np.concatenate([pair(cplx(0.05, 0.5)) for _ in range(ns)],
                            -1).reshape(nb, size, size, 2 * ns)
    # legacy (R2*, FM): fa_forward ignores R2*, fa_cycle zeroes it and
    # fa_get_rho demodulates it
    fa_params = np.stack([0.5 * r2s, phi], -1)
    fa_maps = np.concatenate([fa_rho, fa_params], -1).astype(np.float32)

    def run(where):
        m = torch.from_numpy(maps).to(where)
        te = physics.te_train(NE, nb, device=where)
        te12 = physics.te_train(2 * NE, nb, device=where)
        pm4 = torch.cat([m[:, 2:3], torch.zeros_like(m[:, :2]), m[:, 3:4]],
                        dim=1)
        acqs = physics.synthesize(m, te)
        rho, demod = physics.fit_rho(acqs, pm4, te, acq_demod=True)
        fam = torch.from_numpy(fa_maps).to(where)
        fa_acqs = physics.fa_forward(fam, te12)
        fa_rho_hat, fa_recon = physics.fa_cycle(fa_acqs, fam[..., 2 * ns:],
                                                te12)
        fa_meb = layouts.acqs_to_mebcrn(fa_acqs)
        fm_r2 = torch.stack([fam[..., 2 * ns + 1], fam[..., 2 * ns]], -1)
        fa_get = physics.fa_get_rho(fa_meb, fm_r2, te12)
        recon_rho, recon = compat.acq_to_acq(acqs, m[:, 2:3], te)
        legacy = layouts.acqs_from_mebcrn(acqs)
        pm_leg = torch.stack([m[:, 2, ..., 1], m[:, 2, ..., 0]], -1)
        leg_rho, leg_demod = compat.get_rho(legacy, pm_leg, te=te,
                                            MEBCRN=False, acq_demod=True)
        return dict(bipolar_synthesize=acqs, bipolar_fit_rho=rho,
                    acq_demod=demod, fa_forward=fa_acqs,
                    fa_cycle_rho=fa_rho_hat,
                    fa_cycle_recon=fa_recon, fa_get_rho=fa_get,
                    acq_to_acq_rho=recon_rho, acq_to_acq_recon=recon,
                    get_rho_legacy=leg_rho, get_rho_legacy_demod=leg_demod)

    with torch.no_grad():
        card = {k: v.cpu() for k, v in run(dev).items()}
        cpu = run(torch.device("cpu"))
    out = beyond_allowance(card, cpu)
    # the round trip inverts the synthesis where R2* ≥ 0 (all of it here)
    truth = torch.from_numpy(maps[:, :2])
    out["round_trip_max_err"] = float(
        (cpu["bipolar_fit_rho"] - truth).abs().max())
    return out


def beyond_allowance(card: dict, cpu: dict) -> dict:
    """Per output name: the elements of `card` beyond 1e-5 + 1e-4·|CPU|
    from `cpu` and the largest gap over that allowance; "ok" where none
    is."""
    atol, rtol = IO_PHYSICS_TOL
    out = {}
    for k, ref in cpu.items():
        over = (card[k] - ref).abs() - (atol + rtol * ref.abs())
        out[k] = dict(beyond=int((over > 0).sum()),
                      worst_over_allowance=float(over.max()))
    out["ok"] = all(v["beyond"] == 0 for v in out.values())
    return out


def check_io(r: dict, on_card: bool = True) -> None:
    """The io phase's gates: the native parser built, its series equal to
    the Python walk's bit for bit and within the quantisation bound of the
    source, the NIfTI set within 1e-6 of `nifti_expected`; each train run
    one epoch of finite losses on exactly the loader's cohort and the 1.5 T
    TE train, with the cycle and both ConvLSTM kernels launched (the train
    phase's 2, 2 and 24 a step pair); the served maps finite, the fit and
    ConvLSTM forward launched, every exported pixel equal to the npz's;
    item 9's physics card against CPU within 1e-5 + 1e-4·|CPU|. Off the
    card (`on_card` False, the rehearsal) no kernel launches."""
    ld = r["loaders"]
    if not ld["native_built"] or not ld["native_equal_python"] \
            or ld["quantisation_max_err"] > ld["quantisation_bound"] \
            or ld["nifti_max_err"] > 1e-6:
        raise AssertionError(f"io loaders: {ld}")
    for name in ("train_dicom", "train_nifti"):
        run = r[name]
        lau, steps = run["launches"], run["steps"]
        short = {k: v for k, v in (("ideal_cycle", 2), ("convlstm_bwd", 2),
                                   ("convlstm_fwd", 24))
                 if on_card and lau.get(k, 0) < v * steps}
        if steps < 1 or short or not run["finite"] \
                or not run["cohort_equal"] or not run["te_equal"]:
            raise AssertionError(f"io {name}: steps {steps}, short {short}, "
                                 f"finite {run['finite']}, cohort "
                                 f"{run['cohort_equal']}, te "
                                 f"{run['te_equal']}: {run['epochs']}")
    inf = r["infer"]
    served = {k: inf["launches"].get(k, 0) for k in ("ideal_fit",
                                                     "convlstm_fwd")}
    bad_pixels = any(inf["readback"]["mismatched_pixels"].values())
    if not inf["finite"] or bad_pixels \
            or (on_card and min(served.values()) < 1):
        raise AssertionError(f"io infer: {inf}")
    if not r["physics"]["ok"]:
        raise AssertionError(f"item 9's physics, card vs CPU: "
                             f"{r['physics']}")


# ------------------------------------------------------------------ parallel
# AI-DEAL's step pair per rank at batch 4 (the train phase's launches per
# pair: the cycle once a step, the ConvLSTM forward and backward)
DP_PAIR_LAUNCHES = {"ideal_cycle": 2, "convlstm_fwd": 34, "convlstm_bwd": 14}
DP_JOIN_S = 300
LAUNCHER_S = 300


def parallel_devices(dev) -> list:
    """The devices the split phases use: every card where there are two or
    more, else `dev` twice (one card runs both shards, which exercises the
    split); on the CPU, the CPU twice."""
    import torch
    n = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n >= 2:
        return [torch.device("cuda", i) for i in range(n)]
    return [dev, dev]


def dp_arrangement(dev) -> tuple[str, list]:
    """The data-parallel phase's backend and its two ranks' devices: NCCL
    with a card per rank where there are two or more cards, else gloo with
    both ranks on `dev` (asked for by name here, never a fallback of the
    package)."""
    devs = parallel_devices(dev)[:2]
    if dev.type == "cuda" and devs[0] != devs[1]:
        return "nccl", devs
    return "gloo", devs


def sharded_fit_phase(dev, size: int = SIZE) -> dict:
    """`parallel.make_sharded_fit` over `parallel_devices(dev)`: the slice
    split at nb=8 and the H split at nb=2 each against the unsplit
    `fit_rho_planar` on `dev` bit for bit, one fit launch per shard, the
    indivisible case raising, and the times of the split and the one call."""
    import torch
    from ideal_gan_tpu_torch import ops
    from ideal_gan_tpu_torch.parallel import make_sharded_fit

    devs = parallel_devices(dev)
    out = {"devices": [str(d) for d in devs]}
    for name, nb, voxel in (("slice", NB_SERVE, False), ("h", 2, True)):
        acqs, maps, te = bench_inputs(nb, size, dev)
        args = (acqs[..., 0].contiguous(), acqs[..., 1].contiguous(),
                maps[:, 2, ..., 0].contiguous(),
                maps[:, 2, ..., 1].contiguous(), te)
        whole = ops.fit_rho_planar(*args)
        fit = make_sharded_fit(devs, voxel_axis=voxel)
        split, _, launches = counted(dev, lambda: fit(*args))
        out[name] = dict(
            nb=nb, bit_equal=all(torch.equal(a, b)
                                 for a, b in zip(split, whole)),
            launches=launches, shards=len(devs),
            ms=time_ms(lambda: fit(*args), dev),
            one_call_ms=time_ms(lambda: ops.fit_rho_planar(*args), dev))
    acqs, maps, te = bench_inputs(len(devs) + 1, size, dev)
    try:
        make_sharded_fit(devs)(acqs[..., 0], acqs[..., 1], maps[:, 2, ..., 0],
                               maps[:, 2, ..., 1], te)
        out["indivisible_raises"] = False
    except ValueError as e:
        out["indivisible_raises"] = "divide" in str(e)
    return out


def check_sharded_fit(r: dict, on_card: bool = True) -> None:
    bad = {k: v for k, v in r.items() if k in ("slice", "h") and (
        not v["bit_equal"]
        or (on_card and v["launches"]["ideal_fit"] != v["shards"]))}
    if bad or not r["indivisible_raises"]:
        raise AssertionError(f"sharded fit: {bad or r}")


def _dp_setup(dev, size: int, batch: int, f: int, mesh=None):
    """The AI-DEAL PM trainer on `dev` from seeded weights: (cfg, state,
    FM step, R2 step, the batch: the whole of it, or the rank's rows on a
    mesh). The batch is the synthetic cohort with N(0, 1e-3) noise, as in
    `step_parity`."""
    import numpy as np
    import torch
    from ideal_gan_tpu_torch.cli.common import synthetic_dataset
    from ideal_gan_tpu_torch.parallel import shard_batch
    from ideal_gan_tpu_torch.train import unsup

    cfg = dict(unsup.DEFAULTS, n_G_filters=f, out_vars="PM",
               batch_size=batch, epochs=1)
    acqs, _, te = synthetic_dataset(batch, h=size, w=size, ne=NE, seed=1)
    acqs = acqs + 1e-3 * np.random.default_rng(2).normal(
        size=acqs.shape).astype(np.float32)
    g_fm, g_r2 = unsup.build_models(cfg)
    step, tx = unsup.make_train_step(cfg, g_fm, g_r2, mesh)
    r2_step = unsup.make_r2_train_step(cfg, g_fm, g_r2, tx, mesh)
    state = unsup.init_state(cfg, g_fm, g_r2, tx,
                             torch.Generator().manual_seed(3), dev, mesh)
    b = shard_batch((acqs, te), mesh) if mesh is not None else \
        (torch.from_numpy(acqs).to(dev), torch.from_numpy(te).to(dev))
    return cfg, state, step, r2_step, b


def _fm_grads(net) -> dict:
    return {f"0.{n}": p.grad.detach().cpu().clone()
            for n, p in net.named_parameters() if p.grad is not None}


def _dp_rank(rank: int, init: str, backend: str, devices: list,
             out_dir: str, size: int, batch: int, f: int,
             pairs: int) -> None:
    """One rank of the data-parallel phase (a spawned process): `pairs` FM
    and R2 step pairs on its rows of the global batch, with the launches,
    ms and parameters after each pair, the first FM step's loss (averaged
    over the ranks) and gradients (averaged by the optimizer), the
    all-reduce's time and the peak memory, saved to <out_dir>/rank<r>.pt."""
    sys.path.insert(0, str(ROOT))
    import torch
    from ideal_gan_tpu_torch import ops
    from ideal_gan_tpu_torch.parallel import data_mesh, initialize_distributed
    from ideal_gan_tpu_torch.parallel.mesh import (all_reduce_grads,
                                                   reduce_metrics)
    dev = torch.device(devices[rank])
    if dev.type == "cpu":  # the CPU rehearsal: two ranks share the cores
        torch.set_num_threads(1)
    assert initialize_distributed(
        init, 2, rank, local_device_ids=[dev.index or 0], backend=backend,
        device=dev.type, timeout_s=120)
    set_tf32(False)
    mesh = data_mesh(device=dev)
    cfg, state, step, r2_step, b = _dp_setup(dev, size, batch, f, mesh)
    out = {"params": [], "launches": [], "ms": [], "backend": backend}
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for pair in range(pairs):
        for k in ops.KERNELS:
            k.launches = 0
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        if pair == 0:
            grads0 = _fm_grads(state.g_fm)
        state, _ = r2_step(state, b)
        sync()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append({k.name: k.launches for k in ops.KERNELS})
        if pair == 0:
            out["loss0"] = float(reduce_metrics(
                {"G_loss": metrics["G_loss"]}, mesh)["G_loss"])
            out["grads0"] = grads0
        out["params"].append(torch.cat(
            [p.detach().reshape(-1) for net in (state.g_fm, state.g_r2)
             for p in net.parameters()]).cpu())
    params = list(state.g_fm.parameters())

    def reduce():
        all_reduce_grads(params, mesh)
        sync()

    reduce()
    t0 = time.perf_counter()
    for _ in range(5):
        reduce()
    out["allreduce_host_ms"] = (time.perf_counter() - t0) * 1e3 / 5
    out["allreduce_device_ms"] = device_ms_by(
        reduce, dev, {"nccl": "nccl", "memcpy": "Memcpy"}, iters=5)
    out["grad_bytes"] = sum(p.numel() * p.element_size() for p in params)
    out["peak_memory_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                             if dev.type == "cuda" else None)
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def dp_phase(dev, out_dir: Path, size: int = SIZE, batch: int = NB_SERVE,
             f: int = F_MAIN, pairs: int = 2) -> dict:
    """Data-parallel AI-DEAL training on two ranks (spawned processes,
    `dp_arrangement`'s backend), TF32 off, against the one-process step on
    the whole batch on `dev` and a float64 witness there (the plain
    ConvLSTM)."""
    import copy
    import multiprocessing

    import torch
    from ideal_gan_tpu_torch.train import unsup

    backend, devices = dp_arrangement(dev)
    set_tf32(False)
    cfg, state, step, r2_step, b = _dp_setup(dev, size, batch, f)
    nets0 = [copy.deepcopy(n) for n in (state.g_fm, state.g_r2)]
    state, metrics = step(state, b)
    ref = dict(loss=float(metrics["G_loss"]), grads=_fm_grads(state.g_fm))
    ref["metrics"] = {"G_loss": ref["loss"]}

    def pair():
        r2_step(*step(state, b)[:1], b)

    one_ms = time_ms(pair, dev, iters=2, warmup=1)
    off = torch.zeros((), device=dev)
    with plain_convlstm():
        ref64 = _step_run(lambda g_fm, g_r2: unsup.make_loss_fn(
            cfg, g_fm, g_r2), nets0, [off, *b], dev, torch.float64)
    ref64["grads"] = {k: v for k, v in ref64["grads"].items()
                      if k.startswith("0.")}
    del state, nets0, pair
    init = f"file://{out_dir / 'rendezvous'}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_dp_rank, args=(
        r, init, backend, [str(d) for d in devices], str(out_dir), size,
        batch, f, pairs)) for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + DP_JOIN_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    wall = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    if codes != [0, 0]:
        raise AssertionError(f"data-parallel ranks exited {codes}")
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    card = dict(loss=ranks[0]["loss0"], grads=ranks[0]["grads0"],
                metrics={"G_loss": ranks[0]["loss0"]})
    return dict(
        backend=backend, devices=[str(d) for d in devices],
        global_batch=batch, rows_per_rank=batch // 2, wall_s=wall,
        one_process_ms_per_step_pair=one_ms,
        params_bit_equal=[bool(torch.equal(a, b)) for a, b in
                          zip(ranks[0]["params"], ranks[1]["params"])],
        loss_rank0=ranks[0]["loss0"], loss_rank1=ranks[1]["loss0"],
        parity=_parity_of(card, ref, ref64),
        launches=[r["launches"] for r in ranks],
        ms_per_step_pair=[r["ms"] for r in ranks],
        allreduce_host_ms=[r["allreduce_host_ms"] for r in ranks],
        allreduce_device_ms=[r["allreduce_device_ms"] for r in ranks],
        allreduce_bytes=ranks[0]["grad_bytes"],
        peak_memory_gb=[r["peak_memory_gb"] for r in ranks])


def check_dp(r: dict, on_card: bool = True) -> None:
    p = r["parity"]
    bad_launches = [ln for rank in r["launches"] for ln in rank
                    if on_card and any(ln[k] != v for k, v in
                                       DP_PAIR_LAUNCHES.items())]
    if not all(r["params_bit_equal"]) or r["loss_rank0"] != r["loss_rank1"] \
            or p["loss_rel_diff"] > 2e-5 or p["grad_max_rel"] > 2e-2 \
            or bad_launches:
        raise AssertionError(
            f"data-parallel step ({r['backend']}): ranks equal "
            f"{r['params_bit_equal']}, loss {p['loss_rel_diff']}, gradients "
            f"{p['grad_max_rel']}, launches {bad_launches}")


def _run_launcher(out_dir: Path, nproc: int, flags) -> tuple[int, str]:
    """`python -m torch.distributed.run --standalone --nproc_per_node
    <nproc> -m ideal_gan_tpu_torch.cli.train_unsup <flags>` in its own
    process group, killed whole after `LAUNCHER_S`: (exit code, output)."""
    import os
    import signal
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), "-m",
           "ideal_gan_tpu_torch.cli.train_unsup", *flags]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK"):
        env.pop(k, None)
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=LAUNCHER_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
    return proc.returncode, out


def launcher_phase(dev, out_dir: Path, size: int = SIZE, n: int = 16,
                   batch: int = NB_SERVE, f: int = F_MAIN) -> dict:
    """`cli.train_unsup` through the launcher, one process per card (on
    the CPU, two), for one epoch, then a resume to two: exit codes, and
    rank 0's files only (one settings.yml, one checkpoint directory, one
    event file)."""
    import torch
    nproc = torch.cuda.device_count() if dev.type == "cuda" else 2
    flags = ["--synthetic", str(n), "--data_size", str(size), "--batch_size",
             str(batch), "--n_G_filters", str(f), "--out_vars", "PM",
             "--output_base", str(out_dir)]
    if dev.type != "cuda":
        flags += ["--device", "cpu"]
    t0 = time.perf_counter()
    rc, log = _run_launcher(out_dir, nproc, [*flags, "--epochs", "1"])
    wall = time.perf_counter() - t0
    run = out_dir / "Unsup-v0"
    files = dict(
        settings=sorted(p.name for p in run.glob("settings*")),
        checkpoint_dirs=sorted(p.name for p in run.glob("checkpoints*")),
        checkpoints=sorted(p.name for p in (run / "checkpoints").glob("*")),
        event_files=len(list((run / "summaries").rglob("events.*"))))
    t0 = time.perf_counter()
    rc2, log2 = _run_launcher(out_dir, nproc, [*flags, "--epochs", "2"])
    return dict(nproc=nproc, exit_code=rc, wall_s=wall, files=files,
                epoch_lines=[ln for ln in log.splitlines()
                             if ln.startswith("epoch ")],
                resume_exit_code=rc2, resume_wall_s=time.perf_counter() - t0,
                resumed_lines=log2.count("resumed from epoch 1"),
                resume_checkpoints=sorted(
                    p.name for p in (run / "checkpoints").glob("*")),
                log_tail=(log + log2)[-2000:] if rc or rc2 else "")


def check_launcher(r: dict) -> None:
    files = r["files"]
    if r["exit_code"] or r["resume_exit_code"] \
            or files["settings"] != ["settings.yml"] \
            or files["checkpoint_dirs"] != ["checkpoints"] \
            or files["checkpoints"] != ["ckpt-1.pt"] \
            or files["event_files"] != 1 or r["resumed_lines"] != 1 \
            or "ckpt-2.pt" not in r["resume_checkpoints"]:
        raise AssertionError(f"launcher run: {r}")


def serving_split_phase(dev, size: int = SIZE, batch: int = NB_SERVE,
                        f: int = F_MAIN) -> dict:
    """An AI-DEAL chunk of `batch` through `_per_slice`, split over
    `parallel_devices(dev)` (one net replica each) and unsplit, TF32 off,
    counted; the fit on identical net outputs, split and whole."""
    import numpy as np
    import torch
    from ideal_gan_tpu_torch import ops
    from ideal_gan_tpu_torch.cli import infer, roi_analysis
    from ideal_gan_tpu_torch.cli.common import load_cohorts
    from ideal_gan_tpu_torch.parallel.serving import device_context

    devs = parallel_devices(dev)
    set_tf32(False)
    cfg = dict(infer.DEFAULTS, model_sel="AI-DEAL", seed=0, synthetic=batch,
               data_size=size, n_G_filters=f)
    acqs, _, te = load_cohorts(cfg)
    one_run = roi_analysis.make_infer_run(cfg, acqs, dev, devices=[dev])
    split_run = roi_analysis.make_infer_run(cfg, acqs, dev, devices=devs)
    one, wall_one, launches_one = counted(
        dev, lambda: roi_analysis._per_slice(one_run, acqs, te, batch, dev))
    split, wall_split, launches = counted(
        dev, lambda: roi_analysis._per_slice(split_run, acqs, te, batch,
                                             dev))
    from ideal_gan_tpu_torch.parallel.mesh import split_count
    n = split_count(batch, len(devs))
    g_fm, g_r2, off = roi_analysis.load_models(cfg, dev)
    a, t = torch.from_numpy(acqs).to(dev), torch.from_numpy(te).to(dev)
    with torch.inference_mode():
        (fm, _), (r2, _) = roi_analysis.aideal_heads(g_fm, g_r2, off, a)
        pm = torch.cat([fm, r2], dim=-1)
        whole = ops.fit_rho_fused(a, pm, t, field=1.5)
        per = batch // n
        parts = []
        for j, d in enumerate(devs[:n]):
            rows = slice(j * per, (j + 1) * per)
            with device_context(d):
                parts.append(ops.fit_rho_fused(a[rows].to(d), pm[rows].to(d),
                                               t[rows].to(d), field=1.5))
        fit_split = torch.cat([p.to(dev) for p in parts])
    return dict(devices=[str(d) for d in devs[:n]], chunk=batch,
                maps_max_abs_diff=float(np.abs(split[0] - one[0]).max()),
                finite=bool(np.isfinite(split[0]).all()),
                fit_bit_equal=bool(torch.equal(fit_split, whole)),
                launches=launches, launches_unsplit=launches_one,
                wall_s=wall_split, wall_unsplit_s=wall_one)


def check_serving_split(r: dict, on_card: bool = True) -> None:
    if not r["finite"] or r["maps_max_abs_diff"] > 5e-3 \
            or not r["fit_bit_equal"] \
            or (on_card and r["launches"]["ideal_fit"] != len(r["devices"])):
        raise AssertionError(f"serving split: {r}")


def parallel_phase(dev, out_dir: Path, size: int = SIZE,
                   batch: int = NB_SERVE, f: int = F_MAIN, n: int = 16,
                   launcher: bool = True) -> dict:
    """The multi-device paths (see `sharded_fit_phase`, `dp_phase`,
    `launcher_phase`, `serving_split_phase`); each checked."""
    import torch
    on_card = dev.type == "cuda"
    out = {"device_count": torch.cuda.device_count() if on_card else 0}
    t0 = time.perf_counter()
    out["sharded_fit"] = sharded_fit_phase(dev, size)
    check_sharded_fit(out["sharded_fit"], on_card)
    out["sharded_fit"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (out_dir / "dp").mkdir()
    out["dp"] = dp_phase(dev, out_dir / "dp", size, batch, f)
    check_dp(out["dp"], on_card)
    out["dp"]["seconds"] = time.perf_counter() - t0
    if launcher:
        t0 = time.perf_counter()
        (out_dir / "launcher").mkdir()
        out["launcher"] = launcher_phase(dev, out_dir / "launcher", size, n,
                                         batch, f)
        check_launcher(out["launcher"])
        out["launcher"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["serving_split"] = serving_split_phase(dev, size, batch, f)
    check_serving_split(out["serving_split"], on_card)
    out["serving_split"]["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# rest: the last modules of the port (Flipout decoders, CriticZ, SGAN, the
# gradient penalty, the complex U-Net, InceptionV3, cli.test_gradients and
# --debug_nans)
# ---------------------------------------------------------------------------

# card vs CPU on the same weights, inputs and noise (TF32 off): an output
# passes within this share of its CPU scale, or else where the card is no
# farther from a float64 witness than this share and GAN_ENVELOPE times the
# CPU's own distance from it (the witness runs only then)
REST_TOL = 1e-4
# cli.test_gradients' one loss and gradient: the field-map net's forward
# (6 echo launches, no gradient), the R2* net's forward (6) and its backward
# (the state recompute's 5 forward launches and 7 backward launches, as in
# DP_PAIR_LAUNCHES' half), one cycle
TEST_GRADIENTS_LAUNCHES = {"ideal_cycle": 1, "convlstm_fwd": 17,
                           "convlstm_bwd": 7}


class _Recorder:
    """A noise source (`prob.noise`) drawing float32 values from a seeded CPU
    generator and keeping them, so that `prob.Replay(self.draws)` hands the
    same draws to another run (on the card, or in float64)."""

    def __init__(self, seed: int):
        import torch
        from ideal_gan_tpu_torch.prob import GeneratorNoise
        self._src = GeneratorNoise(torch.Generator().manual_seed(seed))
        self._like = torch.zeros(())
        self.draws = []

    def _draw(self, kind, shape, like):
        v = getattr(self._src, kind)(shape, self._like)
        self.draws.append((kind, v.numpy()))
        return v.to(dtype=like.dtype, device=like.device)

    def normal(self, shape, like):
        return self._draw("normal", shape, like)

    def rademacher(self, shape, like):
        return self._draw("rademacher", shape, like)

    def uniform(self, shape, like):
        return self._draw("uniform", shape, like)


def _f64(x):
    import torch
    return x.to(torch.complex128 if x.is_complex() else torch.float64)


def _max_gap(got, ref) -> float:
    """max over the outputs of max |got − ref| / max |ref|, on `got`'s
    device (the CPU's outputs copied to the card: the card reduces the
    large ones in a fraction of the CPU's time)."""
    return max(_rel(g.detach().to(r.dtype), r.detach().to(g.device))
               for g, r in zip(got, ref))


def _cpu_run(module, call, inputs, noise):
    """`call` on the CPU on a copy of `module`, without gradients: (its
    outputs, its seconds)."""
    import copy

    import torch
    t0 = time.perf_counter()
    with torch.no_grad():
        out = call(copy.deepcopy(module), *inputs, noise)
    return out, time.perf_counter() - t0


def _card_run(dev, module, call, inputs, draws):
    """`call` on `dev` on a copy of `module` and `inputs` with `draws`
    replayed (TF32 off): the checked outputs (some are the copy's running
    statistics, so no other call may run on that copy)."""
    import copy

    from ideal_gan_tpu_torch.prob import Replay
    return call(copy.deepcopy(module).to(dev), *[x.to(dev) for x in inputs],
                Replay(draws))


def _card_times(dev, module, call, inputs, draws) -> dict:
    """On the card, the ms of one `call` with TF32 off (`ms`) and with TF32
    on (`ms_tf32`, PyTorch's default): CUDA events around one call on a
    fresh copy of `module`, after a warm-up call on that copy (cuDNN's
    algorithm choice and FFT plans are made there); None on the CPU."""
    import copy

    from ideal_gan_tpu_torch.prob import Replay
    if dev.type != "cuda":
        return dict(ms=None, ms_tf32=None)
    args = [x.to(dev) for x in inputs]
    times = {}
    for key, tf32 in (("ms", False), ("ms_tf32", True)):
        timed = copy.deepcopy(module).to(dev)
        set_tf32(tf32)
        try:
            times[key] = time_ms(lambda: call(timed, *args, Replay(draws)),
                                 dev, iters=1, warmup=1)
        finally:
            set_tf32(False)
    return times


def _witness(module, call, inputs, draws):
    """`call` in float64 on the CPU with `draws` replayed, as `_parity`'s
    witness: a reference that shares nothing with the card's run."""
    import copy

    from ideal_gan_tpu_torch.prob import Replay
    return call(copy.deepcopy(module).double(), *[_f64(x) for x in inputs],
                Replay(draws))


def _gap_record(card, times: dict, cpu, cpu_s: float, n_draws: int,
                witness) -> dict:
    """The card's gap to the CPU (`_max_gap`), its times (`_card_times`),
    the CPU's seconds, and where the gap is past REST_TOL and `witness` is
    given, both runs' gaps to the float64 outputs `witness()`."""
    out = dict(gap=_max_gap(card, cpu), **times, cpu_seconds=cpu_s,
               n_draws=n_draws, shape=list(cpu[0].shape), vs_float64=None)
    if out["gap"] > REST_TOL and witness is not None:
        t0 = time.perf_counter()
        wit = witness()
        out["vs_float64"] = {"card": _max_gap(card, wit),
                             "cpu": _max_gap(cpu, wit),
                             "seconds": time.perf_counter() - t0}
    return out


def _module_fails(r: dict) -> bool:
    """Past REST_TOL of the CPU and outside the float64 envelope: farther
    from the CPU's float64 witness than REST_TOL and than GAN_ENVELOPE
    times the CPU (failing where no witness was run)."""
    if r["gap"] <= REST_TOL:
        return False
    vs = r["vs_float64"]
    return vs is None or vs["card"] > max(REST_TOL, GAN_ENVELOPE * vs["cpu"])


# the rest modules held to REST_TOL of the CPU with no float64 envelope
REST_PLAIN = ("inception_v3",)
# PMComplex's complex max-pools in the rest phase's check: 4 levels, in
# its train call and in its eval call
PM_POOLS = 8

_POOL_ROUTER = threading.local()


class _PoolRoutes:
    """Stands in for `complexnn.complex_max_pool_2x2` on the thread that
    sets it (`_routed`). With no `record` it routes each window as the
    port's function does (checked equal to it) and keeps, call by call,
    the windows' |z| and the chosen element on the CPU. Given a `record`
    (the card's), each call takes the recorded routes instead and notes the
    windows whose own argmax would route elsewhere (`flipped`; of them,
    where its own maximum is an exact tie, `flipped_at_ties`), by how much
    its own maximum beats the recorded choice (`max_deficit`), and how far
    its |z| lies from the recorded |z| (`delta`), both over the largest
    |z| of the call. A flip with a deficit within 2·delta is a near-tie
    that the two runs' rounding decides."""

    def __init__(self, record=None):
        self.record = record
        self.calls = []

    def __call__(self, z, port):
        import torch
        b, c, h, w = z.shape
        # the port's window order: (dx, dy), down each column in turn
        win = z.reshape(b, c, h // 2, 2, w // 2, 2).permute(
            0, 1, 2, 4, 5, 3).reshape(b, c, h // 2, w // 2, 4)
        mag = win.abs()
        own = mag.argmax(-1, keepdim=True)
        if self.record is None:
            out = win.gather(-1, own)[..., 0]
            if not torch.equal(out, port(z)):
                raise AssertionError("the recorded max-pool routes are not "
                                     "the port's")
            self.calls.append((mag.cpu(), own.cpu()))
            return out
        rec_mag, rec_idx = self.record[len(self.calls)]
        rec_idx = rec_idx.to(z.device)
        scale = float(mag.max())
        top = mag.gather(-1, own)
        flip = own != rec_idx
        tied = (mag == top).sum(-1, keepdim=True) > 1
        self.calls.append(dict(
            windows=own.numel(), flipped=int(flip.sum()),
            flipped_at_ties=int((flip & tied).sum()),
            max_deficit=float((top - mag.gather(-1, rec_idx)).max()) / scale,
            delta=float((mag - rec_mag.to(mag)).abs().max()) / scale))
        return win.gather(-1, rec_idx)[..., 0]

    def summary(self) -> dict | None:
        """The flips of a run that took a record's routes (None where the
        run pooled nothing)."""
        if not self.calls:
            return None
        return dict(pools=len(self.calls),
                    windows=sum(c["windows"] for c in self.calls),
                    flipped=[c["flipped"] for c in self.calls],
                    flipped_at_ties=[c["flipped_at_ties"]
                                     for c in self.calls],
                    max_deficit=max(c["max_deficit"] for c in self.calls),
                    max_delta=max(c["delta"] for c in self.calls))


@contextlib.contextmanager
def _pool_dispatch():
    """`complexnn.complex_max_pool_2x2` replaced, while the block runs, by
    one that hands each call to the calling thread's `_PoolRoutes`
    (`_routed`) where it has one, else to the port's function."""
    from ideal_gan_tpu_torch.models import complexnn
    port = complexnn.complex_max_pool_2x2

    def dispatch(z):
        routes = getattr(_POOL_ROUTER, "routes", None)
        return port(z) if routes is None else routes(z, port)

    complexnn.complex_max_pool_2x2 = dispatch
    try:
        yield
    finally:
        complexnn.complex_max_pool_2x2 = port


@contextlib.contextmanager
def _routed(routes: _PoolRoutes):
    _POOL_ROUTER.routes = routes
    try:
        yield routes
    finally:
        _POOL_ROUTER.routes = None


def _with_kl(out, module):
    from ideal_gan_tpu_torch import models
    return [out, models.kl_sum(module).reshape(1)]


def rest_modules(dev, size: int = SIZE, gan_size: int = GAN_SIZE,
                 f: int = F_MAIN, num_layers: int = 4, latent: int = 258,
                 sgan_filters: int = 32, sgan_batch: int = NB_SERVE,
                 pm_filters: int = 72, inception_size: int = 139) -> dict:
    """The rest phase's modules on `dev` against the CPU (`_gap_record`), at
    the widths their callers use: BayesDecoder and Decoder(bayes_layer) at
    the GAN's DEFAULTS (latent (1, gan_size/2^L, ., latent), F, L levels),
    train (stochastic) and eval, with their KL sums; CriticZ (64, 3
    levels) on that latent; SGAN (sgan_filters, 5 layers) in train mode on
    `sgan_batch` × 6 folded echoes at size² with its running statistics;
    PMComplex (pm_filters, 4 levels) at size², batch 2, train (with its
    running statistics) then eval, its CPU and float64 runs taking the
    card's max-pool routes (`_PoolRoutes`: the flips counted);
    InceptionV3 features of `sgan_batch` × 6 echoes through
    `echoes_to_inception_input` at inception_size²."""
    import torch
    from ideal_gan_tpu_torch import models
    from ideal_gan_tpu_torch.cli.common import synthetic_dataset
    from ideal_gan_tpu_torch.eval import inception

    gen = torch.Generator().manual_seed(11)
    lat = gan_size // 2 ** num_layers
    z = torch.randn(1, lat, lat, latent, generator=gen)
    bayes = models.BayesDecoder(latent, filters=f, num_layers=num_layers)
    head = models.Decoder(latent, 2, filters=f, num_layers=num_layers,
                          bayes_layer=True)
    critic = models.CriticZ(latent, dim=64, n_downsamplings=3)
    for m in (bayes, head, critic):
        m.init_params(gen)
    acqs, _, _ = synthetic_dataset(sgan_batch, h=size, w=size, ne=NE, seed=4)
    echoes = torch.from_numpy(acqs)
    sgan = models.SGAN(2, num_filters=sgan_filters, num_layers=5)
    sgan.init_params(gen)
    cx = torch.complex(echoes[:2, ..., 0], echoes[:2, ..., 1]).permute(
        0, 2, 3, 1).contiguous()  # (2, H, W, ne) complex64
    pm = models.PMComplex(NE, filters=pm_filters, num_layers=4)
    pm.init_params(gen)
    inc = inception.init_inception_v3()

    def dec(train):
        return lambda m, x, noise: _with_kl(m(x, train=train, noise=noise), m)

    def sgan_call(m, x, noise):
        feats = m(x.reshape((-1,) + tuple(x.shape[2:])), train=True)
        return feats + [m.norms[i].running_mean for i in range(5)] \
            + [m.norms[i].running_var for i in range(5)]

    def pm_call(m, x, noise):
        out = m(x, train=True)
        return [out, *m.buffers(), m(x, train=False)]

    def inc_call(m, x, noise):
        return [m(inception.echoes_to_inception_input(x, inception_size))]

    out = {}
    # the stochastic modules: the CPU first, its draws replayed on the card
    drawn = {"bayes_decoder_train": (bayes, dec(True), 21),
             "bayes_decoder_eval": (bayes, dec(False), 22),
             "decoder_bayes_head_train": (head, dec(True), 23),
             "decoder_bayes_head_eval": (head, dec(False), 24),
             "critic_z": (critic, lambda m, x, noise: [m(x)], 25)}
    with torch.no_grad():
        for name, (m, call, seed) in drawn.items():
            rec = _Recorder(seed)
            cpu, cpu_s = _cpu_run(m, call, [z], rec)
            out[name] = _gap_record(
                _card_run(dev, m, call, [z], rec.draws),
                _card_times(dev, m, call, [z], rec.draws), cpu, cpu_s,
                len(rec.draws),
                lambda m=m, call=call, rec=rec: _witness(m, call, [z],
                                                         rec.draws))
    # the large ones draw nothing. PMComplex runs on the card first, its
    # max-pool routes recorded; then the CPU runs (most of the phase) go to
    # a worker thread, PMComplex's on the card's routes, while the card
    # runs the others and times all three
    big = {"sgan_train": (sgan, sgan_call, [echoes]),
           "pm_complex": (pm, pm_call, [cx]),
           "inception_v3": (inc, inc_call, [echoes])}
    with torch.no_grad(), _pool_dispatch(), ThreadPoolExecutor(1) as pool:
        with _routed(_PoolRoutes()) as card_routes:
            cards = {"pm_complex": _card_run(dev, pm, pm_call, [cx], [])}

        def pinned(run, *args):
            with _routed(_PoolRoutes(card_routes.calls)) as routes:
                return run(*args), routes.summary()

        cpus = {n: pool.submit(pinned, _cpu_run, m, c, x, None)
                for n, (m, c, x) in big.items()}
        for n, (m, c, x) in big.items():
            if n not in cards:
                cards[n] = _card_run(dev, m, c, x, [])
        times = {n: _card_times(dev, m, c, x, [])
                 for n, (m, c, x) in big.items()}
        for n, (m, c, x) in big.items():
            (cpu, cpu_s), routes = cpus[n].result()
            wit = None if n in REST_PLAIN else (
                lambda m=m, c=c, x=x: pinned(_witness, m, c, x, [])[0])
            out[n] = _gap_record(cards[n], times[n], cpu, cpu_s, 0, wit)
            if routes is not None:
                out[n]["pool_routes"] = routes
    return out


def rest_gradient_penalty(dev, size: int = GAN_SIZE, f: int = F_MAIN,
                          d: int = D_GAN) -> dict:
    """`losses.gradient_penalty` in wgan-gp and dragan modes through the
    GAN's PatchGAN (its DEFAULTS, `d` wide) on a batch of one slice's 6
    echoes at size², on `dev` and on the CPU with the same α (and β) drawn
    once (`_parity`, its witness lazy): the penalty and the gradient of the
    critic's double backward."""
    import numpy as np
    import torch
    from ideal_gan_tpu_torch import losses
    from ideal_gan_tpu_torch.cli.common import synthetic_dataset
    from ideal_gan_tpu_torch.prob import Replay
    from ideal_gan_tpu_torch.train import gan

    cfg = _gan_cfg(size, f, 1, 1, d=d)
    acqs, _, _ = synthetic_dataset(1, h=size, w=size, ne=NE, seed=5)
    rng = np.random.default_rng(6)
    real = torch.from_numpy(acqs)
    fake = torch.from_numpy((0.9 * acqs + 0.02 * rng.normal(
        size=acqs.shape)).astype(np.float32))
    disc = gan.build_models(cfg).disc
    disc.init_params(torch.Generator().manual_seed(7))
    alpha = rng.uniform(size=(1, 1, 1, 1, 1)).astype(np.float32)
    beta = rng.uniform(size=acqs.shape).astype(np.float32)
    out = {}
    for mode, draws in (("wgan-gp", [("uniform", alpha)]),
                        ("dragan", [("uniform", beta), ("uniform", alpha)])):
        def make(critic, mode=mode, draws=draws):
            def loss(r, fk):
                gp = losses.gradient_penalty(
                    lambda x: critic(x, update_stats=False), r, fk, mode,
                    Replay(draws))
                return gp, {}
            return loss
        out[mode] = _parity(make, (disc,), (real, fake), dev,
                            lazy_witness=True)
        tdisc = disc.to(dev)
        args = (real.to(dev), fake.to(dev))

        def step(mode=mode, draws=draws):
            tdisc.zero_grad()
            make(tdisc, mode, draws)(*args)[0].backward()

        out[mode]["ms"] = time_ms(step, dev, iters=3, warmup=1)
        disc.cpu()
    return out


def _tg_flags(dev, out_dir: Path, size: int, over=()) -> list:
    flags = dict(synthetic=2, data_size=size, device=str(dev),
                 output_base=str(out_dir), **dict(over))
    return [x for k, v in flags.items() for x in (f"--{k}", str(v))]


def rest_test_gradients(dev, out_dir: Path, size: int = SIZE,
                        f: int = F_MAIN, downsample: int = 8) -> dict:
    """`cli.test_gradients.main` on `dev` at its DEFAULTS (F=8, every
    `downsample`-th pixel of 2 synthetic size² slices) and at F=`f` with
    `--downsample 1`, each counted; then each configuration's loss and R2*
    gradient on `dev` and on the CPU from the same weights and batch
    (`_parity`)."""
    import torch
    from ideal_gan_tpu_torch.cli import test_gradients as tg
    from ideal_gan_tpu_torch.cli.common import synthetic_dataset
    from ideal_gan_tpu_torch.train import unsup

    out = {}
    for name, over in (("defaults", {"downsample": downsample}),
                       (f"f{f}_full", {"n_G_filters": f, "downsample": 1})):
        argv = _tg_flags(dev, out_dir, size, over)
        res, wall, launches = counted(dev, lambda: tg.main(argv))
        cfg = dict(tg.DEFAULTS, **over)
        g_fm, g_r2 = unsup.build_models(tg.unsup_config(cfg))
        gen = torch.Generator().manual_seed(0)
        g_fm.init_params(gen)
        g_r2.init_params(gen)
        acqs, _, te = synthetic_dataset(2, h=size, w=size, ne=NE)
        ds = cfg["downsample"]
        A = torch.from_numpy(acqs[:, :, ::ds, ::ds].copy())

        def make(r2, fm, cfg=cfg):
            fn = tg.make_loss_fn(cfg, fm, r2)
            return lambda a, t: (fn(a, t), {})

        parity = _parity(make, (g_r2, g_fm), (A, torch.from_numpy(te)),
                         dev, lazy_witness=True)
        out[name] = dict(loss=res["loss"], max_grad=res["max_grad"],
                         finite=all(bool(torch.isfinite(g).all())
                                    for g in res["grads"].values()),
                         seconds=wall, launches=launches, parity=parity,
                         size=A.shape[-2])
    return out


def rest_debug_nans(dev, out_dir: Path, size: int = SIZE,
                    downsample: int = 8) -> dict:
    """`--debug_nans 1`: cli.test_gradients at its DEFAULTS (every
    `downsample`-th pixel) with and without the flag (the same loss), then
    the harness's loss and gradient on `dev` under the sanitizer with a NaN
    in the R2* head's weight, which must raise at the head's convolution,
    forward; then the ConvLSTM forward and backward wrappers at the
    harness's shapes under the sanitizer with a NaN in an input, which
    must raise naming the kernel (on the CPU, the plain version's op)."""
    import torch
    from ideal_gan_tpu_torch import ops
    from ideal_gan_tpu_torch.cli import test_gradients as tg
    from ideal_gan_tpu_torch.cli.common import synthetic_dataset
    from ideal_gan_tpu_torch.train import unsup
    from ideal_gan_tpu_torch.utils import nans

    ds = {"downsample": downsample}
    plain = tg.main(_tg_flags(dev, out_dir, size, ds))
    t0 = time.perf_counter()
    try:
        checked = tg.main(_tg_flags(dev, out_dir, size,
                                    {**ds, "debug_nans": 1}))
        on = nans.debug_nans_enabled()
    finally:
        nans.set_debug_nans(False)
    checked_s = time.perf_counter() - t0
    cfg = dict(tg.DEFAULTS, **ds)
    g_fm, g_r2 = unsup.build_models(tg.unsup_config(cfg))
    gen = torch.Generator().manual_seed(0)
    for net in (g_fm, g_r2):
        net.init_params(gen)
        net.to(dev)
    with torch.no_grad():
        g_r2.head.weight[0, 0, 0, 0] = float("nan")
    acqs, _, te = synthetic_dataset(2, h=size, w=size, ne=NE)
    ds = cfg["downsample"]
    A = torch.from_numpy(acqs[:, :, ::ds, ::ds].copy()).to(dev)

    def raised(fn):
        try:
            with nans.DebugNaNs():
                fn()
        except FloatingPointError as e:
            return str(e)
        return None

    error = raised(lambda: tg.grad_check(cfg, g_fm, g_r2, A,
                                         torch.from_numpy(te).to(dev)))
    # a NaN in the ConvLSTM kernels' inputs at the harness's shapes (x, and
    # the backward's dL/dh), made before the sanitizer is on: no ATen op
    # computes a NaN before the kernel does
    f = cfg["n_G_filters"]
    gen = torch.Generator().manual_seed(3)
    x, k, b, g = (torch.randn(*s, generator=gen).to(dev) for s in (
        (A.shape[0], NE, A.shape[2], A.shape[3], 2), (3, 3, 2 + f, 4 * f),
        (4 * f,), (A.shape[0], A.shape[2], A.shape[3], f)))
    x_nan, g_nan = x.clone(), g.clone()
    x_nan[0, 1, 2, 3, 0] = float("nan")
    g_nan[0, 2, 3, 0] = float("nan")
    return dict(loss=plain["loss"], loss_checked=checked["loss"],
                same_loss=plain["loss"] == checked["loss"],
                flag_was_on=on, seconds_checked=checked_s, nan_error=error,
                kernel_nan_errors={
                    "convlstm_fwd": raised(lambda: ops.convlstm_forward(
                        x_nan, k, b)),
                    "convlstm_bwd": raised(lambda: ops.convlstm_backward(
                        x, k, b, g_nan))})


def rest_phase(dev, out_dir: Path, size: int = SIZE,
               gan_size: int = GAN_SIZE, f: int = F_MAIN, d: int = D_GAN,
               num_layers: int = 4, latent: int = 258,
               sgan_filters: int = 32, sgan_batch: int = NB_SERVE,
               pm_filters: int = 72, inception_size: int = 139,
               downsample: int = 8) -> dict:
    """The rest phase (module docstring), TF32 off: `rest_modules`,
    `rest_gradient_penalty`, `rest_test_gradients`, `rest_debug_nans`, with
    the seconds of each."""
    set_tf32(False)
    parts = {
        "modules": lambda: rest_modules(
            dev, size, gan_size, f, num_layers, latent, sgan_filters,
            sgan_batch, pm_filters, inception_size),
        "gradient_penalty": lambda: rest_gradient_penalty(dev, gan_size, f,
                                                          d),
        "test_gradients": lambda: rest_test_gradients(dev, out_dir, size, f,
                                                      downsample),
        "debug_nans": lambda: rest_debug_nans(dev, out_dir, size,
                                              downsample)}
    out, secs = {}, {}
    for name, run in parts.items():
        t0 = time.perf_counter()
        out[name] = run()
        secs[name] = time.perf_counter() - t0
    out["seconds_by_part"] = secs
    return out


def check_rest(r: dict, on_card: bool = True) -> None:
    """The rest phase's gates: every module within REST_TOL of the CPU or
    inside the envelope of the CPU's float64 witness (`_module_fails`;
    REST_PLAIN within REST_TOL alone), PMComplex's CPU run on the card's
    routes in all PM_POOLS max-pools; the penalties and cli.test_gradients'
    steps within `_gan_parity_failures`' rule (loss 2e-5, gradients 2e-2
    of scale, or the float64 envelope); the harness's gradients finite and
    non-zero and its launches exactly TEST_GRADIENTS_LAUNCHES (on the
    card); --debug_nans: the same loss, a NaN named at the convolution,
    the NaNs in the ConvLSTM kernels' inputs caught (on the card, named at
    the kernel)."""
    bad = {k: v for k, v in r["modules"].items()
           if (v["gap"] > REST_TOL if k in REST_PLAIN else _module_fails(v))}
    if bad:
        raise AssertionError(f"card and CPU modules disagree: {bad}")
    routes = r["modules"]["pm_complex"].get("pool_routes")
    if routes is None or routes["pools"] != PM_POOLS:
        raise AssertionError(f"PMComplex's CPU run took the card's routes "
                             f"in {routes} of its {PM_POOLS} max-pools")
    fails = _gan_parity_failures(dict(r["gradient_penalty"]))
    fails.update(_gan_parity_failures(
        {k: v["parity"] for k, v in r["test_gradients"].items()}))
    if fails:
        raise AssertionError(f"card and CPU steps disagree: {fails}")
    for name, run in r["test_gradients"].items():
        if not run["finite"] or not run["max_grad"] > 0:
            raise AssertionError(f"test_gradients {name}: gradients not "
                                 f"finite or all zero: {run['max_grad']}")
        want = dict.fromkeys(run["launches"], 0)
        if on_card:
            want.update(TEST_GRADIENTS_LAUNCHES)
        if run["launches"] != want:
            raise AssertionError(f"test_gradients {name} launched "
                                 f"{run['launches']}, not {want}")
    dn = r["debug_nans"]
    if not dn["flag_was_on"] or abs(dn["loss"] - dn["loss_checked"]) > \
            1e-6 * abs(dn["loss"]) or not dn["nan_error"] \
            or "convolution" not in dn["nan_error"]:
        raise AssertionError(f"--debug_nans: {dn}")
    for name, error in dn["kernel_nan_errors"].items():
        if not error or on_card and f"the {name} kernel" not in error:
            raise AssertionError(f"--debug_nans missed the NaN in {name}'s "
                                 f"input: {error}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "ideal_gan_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(ideal_gan_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    smi = smi_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)
    t_start = time.perf_counter()
    build_phase()
    set_tf32(False)
    t0 = time.perf_counter()
    kernels = [fit_entry(dev), convlstm_entry(dev), cycle_entry(dev),
               convlstm_bwd_entry(dev), forward_entry(dev), mag_fit_entry(dev),
               *convlstm_bf16_entries(dev)]
    _LSTM_INPUTS.clear()
    batch_elementwise = convlstm_batch_elementwise(dev)
    per_voxel = per_voxel_batch_elementwise(dev)
    emit("kernels", card=smi, seconds=time.perf_counter() - t0,
         kernels=kernels, batch_elementwise=batch_elementwise,
         per_voxel_batch_elementwise=per_voxel)
    check_batch_elementwise(batch_elementwise)
    check_per_voxel_batch_elementwise(per_voxel)
    set_tf32(True)  # the runs at PyTorch's defaults
    t0 = time.perf_counter()
    # the train phase's run stays on disk until the roi phase serves it
    keep = contextlib.ExitStack()
    train_dir = Path(keep.enter_context(tempfile.TemporaryDirectory(
        prefix=".chip_smoke_", dir=ROOT)))
    train = train_phase(dev, train_dir)
    emit("train", card=smi, seconds=time.perf_counter() - t0, **train)
    need = {"ideal_cycle": 8, "convlstm_bwd": 8, "convlstm_fwd": 96}
    short = {k: v for k, v in train["launches"].items()
             if v < need.get(k, 0)}
    if short:
        raise AssertionError(f"training path skipped kernels: {short}")
    # MODEL_PARITY.json's tolerances: f32 on both sides (TF32 off), sums in
    # other orders through ~20 conv layers, the recurrence and the cycle
    bad = {k: v for k, v in train["parity"].items() if k in ("fm", "r2")
           and (v["loss_rel_diff"] > 2e-5 or v["grad_max_rel"] > 2e-2)}
    if bad:
        raise AssertionError(f"card and CPU train steps disagree: {bad}")
    # on the noise-free cohort the gradients are not held (PERF.md §7), but
    # the loss and every module's forward values are
    witness = train["parity"]["zero_background_fm"]
    worst_fwd = max(r for _, r in witness["forward_rel"])
    if witness["card_vs_cpu"]["loss_rel_diff"] > 2e-5 or worst_fwd > 1e-3:
        raise AssertionError(f"card and CPU FM forwards disagree on the "
                             f"noise-free cohort: loss "
                             f"{witness['card_vs_cpu']}, module outputs "
                             f"{worst_fwd}")
    set_tf32(True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        io = io_phase(dev, Path(tmp))
    emit("io", card=smi, seconds=time.perf_counter() - t0, **io)
    secs = io["loaders"]["seconds_per_folder"]
    print(f"io DICOM loaders ({smi}), host seconds per folder of "
          f"{io['loaders']['files_per_folder']} files: native "
          f"{secs['native']}, python {secs['python']}")
    check_io(io)
    set_tf32(True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        teaug = teaug_phase(dev, Path(tmp))
    emit("teaug", card=smi, seconds=time.perf_counter() - t0, **teaug)
    steps = teaug["steps"]
    if teaug["launches"]["ideal_forward"] != steps or any(
            teaug["launches"][k] < steps
            for k in ("convlstm_fwd", "convlstm_bwd", "ideal_fit")):
        raise AssertionError(f"teaug path skipped kernels in {steps} steps: "
                             f"{teaug['launches']}")
    par = teaug["parity"]
    if par["loss_rel_diff"] > 2e-5 or par["grad_max_rel"] > 2e-2 \
            or max(par["metrics_rel_diff"].values()) > 2e-5:
        raise AssertionError(
            f"card and CPU generator steps disagree: loss "
            f"{par['loss_rel_diff']}, gradients {par['grad_max_rel']}, "
            f"metrics {par['metrics_rel_diff']}")
    set_tf32(True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        e2e = e2e_phase(dev, Path(tmp))
    emit("e2e", card=smi, seconds=time.perf_counter() - t0, **e2e)
    need = {"ideal_fit": 2, "convlstm_fwd": 24}
    short = {k: v for k, v in e2e["launches"].items() if v < need.get(k, 0)}
    if short:
        raise AssertionError(f"main path skipped kernels: {short}")
    # float32 everywhere (TF32 off on the card); cuDNN's and the CPU's
    # convolutions sum in other orders through ~20 conv layers and the
    # 6-echo recurrence, and the fit amplifies field-map error by
    # 2*pi*te*fm_sc
    if e2e["maps_max_abs_err_vs_cpu"] > 5e-3 \
            or e2e["pdff_max_abs_err_vs_cpu"] > 5e-3:
        raise AssertionError(f"card and CPU maps disagree: {e2e}")
    set_tf32(True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        mag = mag_phase(dev, Path(tmp))
    emit("mag", card=smi, seconds=time.perf_counter() - t0, **mag)
    check_mag(mag)
    set_tf32(True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        vet = vetnet_serve_phase(dev, Path(tmp))
    emit("vetnet_serve", card=smi, seconds=time.perf_counter() - t0, **vet)
    check_vetnet_serve(vet)
    set_tf32(True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        sup = sup_phase(dev, Path(tmp))
    emit("sup", card=smi, seconds=time.perf_counter() - t0, **sup)
    check_sup(sup)
    set_tf32(True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        gens = teaug_gens_phase(dev, Path(tmp))
    emit("teaug_gens", card=smi, seconds=time.perf_counter() - t0, **gens)
    check_teaug_gens(gens)
    set_tf32(True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        uq = uq_phase(dev, Path(tmp))
    emit("uq", card=smi, seconds=time.perf_counter() - t0, **uq)
    check_uq(uq)
    set_tf32(True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        sgl = single_phase(dev, Path(tmp))
    emit("single", card=smi, seconds=time.perf_counter() - t0, **sgl)
    check_single(sgl)
    set_tf32(True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        opts = options_phase(dev, Path(tmp))
    emit("options", card=smi, seconds=time.perf_counter() - t0, **opts)
    check_options(opts)
    set_tf32(True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        record = record_phase(dev, Path(tmp))
    emit("record", card=smi, seconds=time.perf_counter() - t0, **record)
    check_record(record)
    set_tf32(True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        pre = preempt_phase(dev, Path(tmp))
    emit("preempt", card=smi, seconds=time.perf_counter() - t0, **pre)
    check_preempt(pre)
    set_tf32(True)
    t0 = time.perf_counter()
    with keep, tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                           dir=ROOT) as tmp:
        roi = roi_phase(dev, Path(tmp), train_dir / "Unsup-v0")
    emit("roi", card=smi, seconds=time.perf_counter() - t0, **roi)
    check_roi(roi)
    set_tf32(True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        phantom = phantom_phase(dev, Path(tmp))
    emit("phantom", card=smi, seconds=time.perf_counter() - t0, **phantom)
    check_phantom(phantom)
    for key, f in phantom["fields"].items():
        for path, medians in f["medians"].items():
            print(f"phantom {key} {path}: "
                  + " ".join(f"{m:.6f}" for m in medians))
    set_tf32(True)
    t0 = time.perf_counter()
    # the gan phase's runs stay on disk until the ldm phase trains on them
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        gan = gan_phase(dev, Path(tmp))
        emit("gan", card=smi, seconds=time.perf_counter() - t0, **gan)
        check_gan(gan)
        set_tf32(True)
        t0 = time.perf_counter()
        ldm = ldm_phase(dev, Path(tmp), Path(tmp) / "gan",
                        Path(tmp) / "gan_bf16")
        emit("ldm", card=smi, seconds=time.perf_counter() - t0, **ldm)
        check_ldm(ldm)
    set_tf32(True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        par = parallel_phase(dev, Path(tmp))
    emit("parallel", card=smi, seconds=time.perf_counter() - t0, **par)
    dp = par["dp"]
    print(f"parallel ({smi}): {par['device_count']} card(s); data-parallel "
          f"backend {dp['backend']} on {dp['devices']}; serving split maps "
          f"max |diff| {par['serving_split']['maps_max_abs_diff']:.3e}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        rest = rest_phase(dev, Path(tmp))
    emit("rest", card=smi, seconds=time.perf_counter() - t0, **rest)
    check_rest(rest)
    print(f"rest ({smi}): card vs CPU, share of scale: " + ", ".join(
        f"{k} {v['gap']:.2e}" for k, v in rest["modules"].items())
        + "; PMComplex's max-pool flips on the card's routes "
        + str(rest["modules"]["pm_complex"]["pool_routes"]["flipped"])
        + "; test_gradients losses " + ", ".join(
        f"{k} {v['loss']:.6f}" for k, v in rest["test_gradients"].items()))
    path_of = {"ideal_fit": e2e, "convlstm_fwd": e2e, "ideal_cycle": train,
               "convlstm_bwd": train, "ideal_forward": teaug,
               "ideal_mag_fit": mag,
               "convlstm_fwd_bf16": opts["unsup_bf16_remat"],
               "convlstm_bwd_bf16": opts["unsup_bf16_remat"]}
    new_paths = {"sup_pm_resynthesis": sup["runs"]["U-Net-PM-resynthesis"],
                 "sup_2d_net_serving": sup["serving_2d_net"],
                 **{f"teaug_{g}": gens[g] for g in TEAUG_GENS},
                 "uq_train": uq["paths"]["uq_train"],
                 "uq_calib": uq["paths"]["uq_calib"],
                 "aideal_uq_serving_pdff": uq["paths"][
                     "aideal_uq_serving_pdff"],
                 "aideal_uq_serving_pdff_var": uq["paths"][
                     "aideal_uq_serving_pdff_var"],
                 "single": sgl,
                 **{f"options_{k}": v for k, v in opts.items()},
                 "roi_aideal": roi,
                 **{f"phantom_{k[6:]}": f
                    for k, f in phantom["fields"].items()},
                 "record": record["trainloop"]["runs"][0],
                 "record_cli": record, "gan": gan["main"],
                 **{f"gan_{k}": r for k, r in gan["short"].items()},
                 "io_train_dicom": io["train_dicom"],
                 "io_train_nifti": io["train_nifti"], "io_infer": io["infer"],
                 "ldm": ldm["main"], "ldm_gen": ldm["gen"],
                 "ldm_metrics": ldm["metrics"], "ldm_bf16": ldm["bf16"],
                 "parallel_fit_slice_split": par["sharded_fit"]["slice"],
                 "parallel_fit_h_split": par["sharded_fit"]["h"],
                 **{f"parallel_dp_rank{r}_pair{i + 1}": {"launches": ln}
                    for r, rank in enumerate(dp["launches"])
                    for i, ln in enumerate(rank)},
                 "parallel_serving_split": par["serving_split"],
                 **{f"rest_test_gradients_{k}": v
                    for k, v in rest["test_gradients"].items()}}
    for k in kernels:
        k["launches"] = path_of[k["name"]]["launches"][k["name"]]
        k["launches_on_new_paths"] = {p: run["launches"][k["name"]]
                                      for p, run in new_paths.items()}
    emit("done", seconds=round(time.perf_counter() - t_start, 3))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
