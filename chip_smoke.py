#!/usr/bin/env python3
"""Smoke run of the PyTorch port (libllsm2_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py breakdown DIR
    python3 chip_smoke.py rows DIR

The third form runs only the checks that rows alone equal their rows in
the batch of phases 9 (from the batch's layer-0 chunk), 10 and 12 on the
package in DIR, each reported and none failing the run.  The second form
runs only phase 5's breakdown (the harmonic_analysis
calls, the harmonic renders, the analysis / synthesis times and peaks,
each analysis stage's time and peak, then the step's sample_cycles calls
and env_render on its chunk at full batch beside their bounds) and phase
7's analysis stages (the refine's time and peak first) on the
libllsm2_tpu_torch package in DIR, another checkout such as the parent
commit's, so that two versions compare on one card; it prints no result
line.  The first form's phases, one line each; any failure exits
non-zero without the final "ok" line:
  1. device: a CUDA card must be present; prints the card's name and
     power limit (nvidia-smi).
  2. build: compiles the port's CUDA kernels from libllsm2_tpu_torch/csrc
     and prints each kernel's registers, spills and static shared memory
     from the ptxas report.
  3. kernels: captures every kernel's inputs on the first 2 rows of the
     path that runs it -- the six of the library-default path (denoiser
     on; K = 80, Wf = 960, plus the K = 4 envelope projection; osc_bank's
     residual and synthesis renders), its frame-axis FIR pair (the
     spectral gate's local-noisiness blend, one launch), its noise draw
     (noise_bins, held to its twin's bits exactly and its normals within
     1e-6) and its cycle track (sample_cycles, within 1e-4 cycles mod 1
     of its twin on the card and 1e-6 of its twin on the CPU, which sums
     in the kernel's order; the analysis's and the synthesis's calls), its
     F0 refine (refine_f0_dec: the decimating FIR and the phase probes in
     one launch, a thread or 16 lanes a frame, within 1e-4 relative of
     its twin), the full-rate F0 refine of phase 7's path at 2 rows
     (refine_f0_full: the copy of x into shared memory and every probe in
     one launch, within 1e-4 relative of its twin), the
     track lowpass's FIR
     pair (track_lowpass_hz=30: a voicing column and a complex track), env_render on the envelope
     coefficients of the main path's noise_mod_ola call, the unframed
     projection of phase 6's hm_kernel="matmul", the plain projection of
     one harmonic_analysis with the mltsine window (K = 80) and, at K = 1,
     of the full-rate refine's first probe on phase 7's 128 rows (the
     twin's framing, [204800, 631]: no path launches harmonic_project at
     K = 1 since refine_f0_full took those calls; also timed at full batch
     beside its bound and yardstick)
     -- runs kernel and plain PyTorch version on them on the card, checks
     the maximum error against each tolerance, and times both (median of
     10, CUDA events) and, where PyTorch computes the same function in
     one contraction, convolution or FFT, that call with the making of
     its operands from the same inputs (the dense oscillator / chirp
     basis, the banded windows, the FIR's layout, the band masks) timed
     with it.  The denoiser
     kernels' other variants (apply's polar output, the time gate alone;
     stats from (ampl, phse) = (|c|, angle c) of the captured complex
     track), denoise_apply's second launch (denoise_finish: the spectral
     gate's delta added, un-aligned, polar, masked) on its captured call,
     and the polar output of deconv_full run on the same inputs.
  4. denoiser off: batched_pipeline on 32 bench rows (16 noisy, 16 clean;
     ChunkConf(f0_floor=70), track_denoise=False, use_pallas=True) after
     zeroing the launch counters; its four kernels and the noise draw must
     have launched, the clean rows must reach 55.17 dB, noisy rows 0 and 1
     must lie within 0.05 dB of the JAX package's values.  Then, after
     one untimed step, the step time (median of 5; phases 5-7 alike).
  5. main path, the library default (create_aoptions(f0_floor=70,
     use_pallas=True): denoiser on, spectral gate at decimation 4) on all
     128 rows x 8 s after zeroing the launch counters: all six kernels,
     fir_frames, noise_bins, sample_cycles and refine_f0_dec must have
     launched (refine_f0_dec also held to its twin at full batch, on row
     0 alone and on a 160-frame block of it, RTAnalyzer's size; its line
     prints its full-batch and 2-row times, bound, ratio and pass split,
     the passes compiled out by refine_f0.cu's LLSM_SKIP_PASS variants),
     clean rows >= 55.17 dB,
     noisy rows 0 and 1 within 0.05 dB and clean row 64 at most 0.1 dB
     under the JAX package's values (denoise_finish launched too).  Then
     the step time (median of 5) and peak memory, each of the step's two harmonic_analysis calls (the K = 80
     main pass, the K = 4 envelope pass) and its two harmonic renders (the
     residual and the synthesis: one osc_bank launch each) at full batch,
     framing, window and glue included (median of 10), the analysis and
     the synthesis apart: time (median of 3) and the peak memory each
     takes above its inputs, and each analysis and synthesis stage's
     synchronized time and peak (the synthesis: sample_cycles, the render,
     _synth_noise split into noise_mod_ola and the shaping before it).
     Rows 0, 1 and 64 run alone, each a batch of one: every field of
     their analysis chunk and their y, y_sin and y_nos must equal, bit for
     bit, the same rows of the 128-row run, as must every sample_cycles call's rows wherever their
     F0 rows are equal, and the kernel on the bench F0 rows alone must
     equal its rows in the batch, as must refine_f0 on the bench rows;
     both runs' SNRs printed.
  6. hm_kernel="matmul" at the library default, all 128 rows x 8 s: the
     main harmonic pass through harmonic_project_mxu (launched), the pins
     of phase 5; prints harmonic_project_mxu's full-batch time beside its
     bound and its yardstick, the SNR change from phase 5, then the five
     steps, their median and the peak.
  7. odd hop: create_aoptions(fs=11000, f0_floor=70, use_pallas=True) and
     create_soptions(fs=11000) on 128 rows x 8 s of the bench fixtures
     made at 11 kHz (hop 55: the undecimated refine, one launch of
     refine_f0_full, envelope decimation 1); refine_f0_full launched once,
     harmonic_project never, and the six kernels of phase 5 launched;
     noisy rows 0/1 within 0.2 dB and clean row 64 at most 0.1 dB under
     the JAX package's values.  Then step and peak; refine_f0_full held
     to its twin at full batch, on row 0 alone and on rows 0 and 1 as one
     3200-frame row, harmonics.refine_f0 on rows 0, 1 and 64 alone equal
     to their rows of the batch bit for bit, its line with the full-batch
     and 2-row times, bound, ratio and pass split (the copy into shared
     memory or the probes compiled out); the analysis's stages, the
     refine's time and peak first (the breakdown form prints these too).
  8. an 11.025 kHz file through the public analyze -> synthesize (numpy
     input, on the card by default; resampled to 11000 Hz, output
     rendered there and resampled back), one noisy and one clean 1 s row
     made at 11025 Hz: output length round(nfrm thop fs), finite, y_sin
     SNR within 0.1 dB of the JAX package's; refine_f0_full launched,
     harmonic_project never.
  9. layer-1 round trip on the 128 x 8 s bench rows: the library-default
     analysis, then chunk_to_layer1 -> chunk_to_layer0 -> _synthesize,
     counters zeroed before; the seven kernels of phase 5 and viterbi_scan
     (the Rd path, twice in chunk_to_layer1) launched; y_sin
     SNR against the clean harmonic part: noisy rows 0/1 within 0.2 dB of
     the JAX package's values, every clean row at most 0.1 dB under the
     JAX value of row 64; rows 0, 1 and 64 alone (a batch of one fed
     that row of each stage's batch input) equal their rows of the batch
     bit for bit through chunk_to_layer1, chunk_to_layer0 and the
     synthesis, and two runs of the batch are equal.  Prints each stage's
     ms, the audio-sec/s of the layer-1 round trip and the peak, and
     _rd_viterbi alone on [128, 1600, 64] uniform scores.  Then
     env_render, which no library
     path runs, renders this chunk's envelopes at full batch through
     layer0._render_envelopes(use_pallas=True), counters zeroed before.
 10. pulse-by-pulse synthesis: 128 rows x 8 s of synth_lf_speech (Rd 0.4 /
     1.0 / 1.8 / 2.7 by row, make_f0_track's contour, aspiration seed =
     row), the library-default analysis -> chunk_to_layer1 ->
     pbp_synthesize, counters zeroed before: noise_mod_ola, fir_frames and
     viterbi_scan launched; each row's median voiced rd within 15% of its truth (the
     JAX suite's criterion) and rows 0 and 1 within 1% of the JAX
     package's medians; row 0's rd track, frame by frame, within 1e-3
     relative of chunk_to_layer1 on the CPU from the same layer-0 row;
     rows 0 and 1: the SNR of PbP y_sin against the layer-1 sinusoidal
     y_sin within 0.2 dB of the JAX package's; rows alone equal their
     batch rows through chunk_to_layer1 and pbp_synthesize, as in phase 9.
     Prints the PbP ms, audio-sec/s and peak.
 11. the corpus from files (BASELINE config 5 on one card): 1000 int16
     WAVs at 16 kHz cut from the bench rows (testsig.write_test_corpus:
     lengths uniform over 0.5-8 s, half noisy, half of each kind with an
     F0 sidecar, the rest tracked by ops/f0.py) through run_corpus_files
     with buckets (200, 400, 800, 1600), batch 64, want_audio=False and
     the library default, counters zeroed before: the native loader
     built; every main-path kernel and viterbi_scan (the tracker's path)
     launched; every file yielded once; a
     second call with the checkpoint yields nothing; the files of the
     first 400-frame batch equal run_corpus on the same int16-quantized
     float signals bit for bit (SNR, y, nx); three tracked files alone (a
     batch of one) equal their batch rows bit for bit (F0 and SNR); the
     first 16 files hold the JAX package's pins (sidecar rows within 0.05
     dB, tracked rows voiced alike in >= 99% of frames and within 0.2 dB).
     Then a warm run, whose SNRs must equal the first's: audio-sec/s from
     files to SNR, per bucket the step, tracker and assembly ms and the
     share of the assembly hidden behind the card, the peak; and the
     tracker alone on 64 x 8 s rows beside its Viterbi (f0.viterbi on
     [64, 1600, 97] uniform scores).  11v: viterbi_scan against its twin
     on the card, paths and last scores equal bit for bit (tolerance 0),
     on phase 9's first captured Rd call ([128, 1600, 64]) and the
     tracker's call on a 64-file 8 s batch ([64, 1600, 97]), on both
     rounded to multiples of 1/8 (the tracker's transitions too: tied
     candidates), on row 0 alone and on rows 0-1, on both with -inf
     entries and tied frames (an unvoiced stretch), on the tracker's rows
     joined into 3200-frame rows (backpointers in device memory); each
     one's kernel time (median of 10, and a launch's share of a run of
     20), its bound and ratio, cycles a step at the SM clock, and the
     twin's time.
 12. the edits (BASELINE config 4) on phase 10's 128 x 8 s layer-1 chunk:
     pitch_shift(2.0) -> time_stretch(1.5) -> synthesize_batch, counters
     zeroed before: osc_bank, noise_mod_ola, noise_bins and sample_cycles
     launched; 2400 frames, every row's voiced median F0 doubled (+- 1%),
     a finite output; rows 0/1 hold the JAX package's frame count, median
     F0 (1e-4 relative) and y_sin rms (0.05 dB); rows alone equal their
     batch rows through the three stages, as in phase 9.  Then the chain's
     stages (median of 3) and each of the ten edits once, ms and peak.
 13. the codec (cell codec-8bit) on phase 10's layer-1 chunk: encode with
     CoderConfig() (64 VT and 32 PSD dims) -> fit_quantizer(bits=8, Rd by
     DPCM, the F0 slot's re-sync) -> coded_save -> coded_load -> decode ->
     synthesize_batch, counters zeroed before: sample_cycles, osc_bank,
     noise_bins and noise_mod_ola launched, a finite output; the archive's
     kbit/s of audio (and at 16 bits), the MCD of the 8- and 16-bit
     decodes against the float decode (median over rows); decode_frames =
     chunk_to_layer0(decode_layer1) bit for bit; random vectors (scales 1,
     1e3, 1e6) decode to finite audio; rows alone equal their batch rows
     (vectors, codes with the batch's quantizer, decode, y); rows 0/1 with
     a quantizer fitted on them: codes equal the JAX package's archive
     (scripts/port_jax_pins_coder.npz) in >= 99% of slots, dequantized
     vectors within one quantizer step of its, the float decode's y_sin rms
     within 0.05 dB and the 8-bit MCD within 0.1 dB of the JAX package's.
     Then each stage's ms (median of 3) and the peak.
 14. the section-model Rd fit (cell nasal-sections): 128 rows x 8 s of
     synth_nasal_utterance (zero (900, 60) Hz, f0_base 120 / 182 / 200 by
     row, seed = row), the library-default analysis, chunk_to_layer1 with
     test_nasal's sections ((250, 70, -1), (900, 60, +1)) and without,
     counters zeroed before the analysis: the main path's analysis
     kernels and viterbi_scan launched; every row's median voiced rd with sections within
     test_nasal's floors ((0.9, 1.15) at 120 Hz, (0.8, 1.25) at 182 and
     200); rows 0/1 within 1% of the JAX package's medians, with and
     without sections; rows alone equal their batch rows.  Prints the
     medians by f0_base and both layer-1 calls' ms (median of 3).
 15. streaming (cell stream-serve), libllsm2_tpu_torch/runtime on the
     library default.  15a, live analysis: runtime.rtanalyze.RTAnalyzer
     (blocks of 64 hops with 48 of halo: each block one layer0._analyze
     call of 160 frames at a batch of one) over bench rows 0, 1 and 64 fed
     997 samples and 13 F0 frames at a time, counters zeroed before ->
     the analysis kernels launched; every row's frame count the offline
     one; with the denoiser on, the ampl SNR against the port's offline
     analysis with the denoiser off >= 20 dB and, rows 0/1, against the
     one with it on within 0.5 dB of the JAX package's; with it off,
     test_rtanalyze.py's floors against the offline analysis.  Prints the
     ms a block (median), one stream's audio-sec/s and the latency.  15b,
     serving: runtime.rtserve.StreamPool(64 streams, feed_block=16) over
     the port's offline chunks of bench rows 0-31 and 64-95, fed 7 frames
     at a time: one render a tick; streams 0, 1 and 32 equal a solo
     stream_chunk(block=16) bit for bit; every stream's y against the
     offline y_sin > 15 dB; row 0 fed frame by frame within 2e-5 of
     feed_many.  Prints the median ms a tick (host assembly, render and
     its copies, commit), streams x realtime, the latency (feed_block + 1
     hops) and the peak.  15c, PbP serving: 4 of phase 10's layer-1 rows in
     a PbP pool (feed_block=16), each stream equal to its solo bit for bit;
     rows 0/1 against offline pbp_synthesize within 0.5 dB of the JAX
     package's; test_runtime.py's 0.6 s PbP stream > 35 dB against offline
     PbP.  15d, the codec stream: phase 13's float vectors of rows 0/1
     decoded 16 frames at a time (decode_frames) into
     RTSynthesizer(phase_mode="propagate"), > 25 dB against the offline
     decode's y_sin over the middle 80%.
 16. the rest of the DSP kit and every option (cell dsp-kit), on the bench
     rows.  16a, the library default create_aoptions(f0_floor=70) /
     create_soptions() (use_pallas=False: the JAX package's jnp branches
     in plain PyTorch, on the card), counters zeroed before: only the
     noise draw and the cycle track launched, none of the Pallas
     counterparts; a finite output on the card; rows 0/1 within 0.05 dB
     and row 64 at most 0.1 dB under the JAX package's use_pallas=False
     values; the step (median of 3 after a warm-up), the analysis and
     synthesis ms and peaks, and the kernel path's step beside it (the
     ratio: what the kernels save); rows 0, 1 and 64 alone equal their
     batch rows bit for bit through analyze and synthesize.  16b, with the
     kernels on: hm_method="pp", hm_passes=2, hm_correction="none" and
     frame_chunk=64 in turn, counters zeroed before each: their kernels
     launched (deconv_full skipped but for frame_chunk), rows 0/1 within
     0.05 dB of the JAX package's (Pallas in interpret mode), step (median
     of 3) and peak; the pp run's denoise_stats call takes polar input and
     is held to its twin at full batch (a case of denoise_stats); the
     frame_chunk chunk equals the unchunked one within 1e-6 of each
     field's peak and its main projection peaks lower; pp's rows alone
     equal the batch.  16c, noise_idft="fft" with the kernels on (the band
     segments by paired inverse FFTs into noise_mod_ola_seg, the segment-
     input entry of noise_mod_ola.cu, launched once) and off: y_nos within
     1e-5 x its rms of the matmul path; noise_mod_ola_seg against its twin
     (5e-5) and timed at full batch beside its bound.  16d, the leaf kit on
     the card against the CPU (1e-4 of the output's peak; the
     instantaneous-frequency detector on 8 rows on the CPU, LPC on the rows
     plus seeded white noise at 0.1 of their rms, which conditions it),
     each op's time; the biquad, a Python loop of a few launches a sample,
     at 1 s and 8 s on one row and on 128, each timed once.
 17. the learned models (cell tts-train-serve), every model at its
     default widths.  17a, the TTS corpus: ttsdata.build_corpus(24,
     seed=0) (224 frames an utterance) with create_aoptions(use_pallas=
     True), counters zeroed before -> the analysis kernels and
     viterbi_scan (its layer-1 fit) launched, the corpus seconds; one utterance with the library default timed.  17b,
     the acoustic model, 400 steps with the F0 slot weighted 4 (ms a step,
     median; first and last loss, < 0.2x; peak), test_acoustic's floors on
     held-out sentences (F0 median error < 0.05, correlation > 0.85, vowel
     identity > 0.75), the unseen sentence [aa s iy sil] served through
     decode_frames -> RTSynthesizer(phase_mode="propagate") with
     test_tts_serving_render's floors, and rendered offline through
     coder.decode -> layer0.synthesize with the kernels (counters zeroed
     before: osc_bank, noise_bins, noise_mod_ola, sample_cycles
     launched).  17c, the AE (lr 3e-3, 100 steps) and the VQ codec (lr
     2e-3, 220 steps) at full batch on phase 13's coder vectors (128 x
     1600): ms a step, test_neural's floors (loss < 0.3x after 60 steps,
     F0 median error < 0.15) and test_vq's (recon < 0.4x, >= 8 codes
     used a group, voicing agreement > 0.9, F0 median error < 0.05), the
     token render's MCD against the float render on rows 0/1 (< 2.5 dB,
     both through the kernels, counted).  17d, the JAX package's weights
     (scripts/port_jax_pins_learned.npz) through params_from_jax on the
     card: forwards within 2e-2 of scale, >= 99% of the VQ tokens equal,
     5 steps' losses within 2e-2 relative.  17e, abs_refine on
     test_abs's weakened analysis: its floors and the JAX package's
     snr_after within 0.05 dB; then bench row 64 at 8 s alone (100 steps,
     lr 0.1): ms a step, the peak, the SNR before and after.
 18. the single-device edges (cell cli-fp64).  18a, a subprocess with
     LLSM_FP64=1 on the card: test_fp64's fixture with every chunk field
     and output float64, the SNR >= 45 dB and within 0.01 dB of the JAX
     package's float64 value, use_pallas refused, no kernel launched, the
     noise drawn on the card (and a bench row's draw there within 2 ulps
     of the host's, JAX's bits, at <= 1e-4 of its normals); then one
     128 x 8 s library-default step in float64 (ms, peak) beside phase
     16a's float32 one.  18b, test_cli's commands through
     libllsm2_tpu_torch.cli on the card with its checks, a 44.1 kHz round
     trip (resampled on the card) and `batch` on 8 files cut from the
     bench rows as phase 11 cuts them.  18c,
     utils.profiling.device_trace around one phase-5 step: the trace holds
     layer0's five llsm.* ranges; the card's busy share of the step (the
     union of its kernel intervals in the trace over the step's
     unprofiled time by CUDA events).
 19. several ranks (cell multi-device): 4 ranks of torch.distributed as
     child processes (mesh_rank: python -c MESH_CHILD), a FileStore
     rendezvous in a temporary directory, the backend by
     distributed.choose_backend (gloo: the 4 ranks share the one card),
     each loading the library phase 2 built; each rank prints its device,
     backend, launches, ms, peaks and the bytes its collectives moved, and
     a failed check in any rank fails the run.  19a, the frame-sharded
     round trip (parallel.seqparallel) of two 64 s utterances (seed 0 with
     noise 0.05, seed 64 clean; 12800 frames, 3200 a rank) at phase 5's
     options, launch counters zeroed before: every kernel of the path
     launched in every rank and every captured call held against its
     plain version (phase 3's tolerances); against this process's
     one-process run on the card: hm_mask, f0, ampl, the complex track
     and psd equal bit for bit (the refine kernel sums each frame in an
     order of its own, and the last block's cycle track ends at the
     signal's end as the one-process lerp does), the round trip's
     y_sin SNR within 0.05 dB of the
     one-process round trip's and of the JAX package's one-process value,
     and no more than 0.05 dB under its sharded one (MESH_PINS_DB, which
     says why); then every stage after the refinement against one
     process fed the sharded F0 (f0_refine off): hm_mask equal, ampl
     2e-6, the complex track 1e-5 and psd 1e-5 on rows [10:-10], edc
     5e-3, the envelope coefficients 8e-3 (1e-3 on rows [4:-4]), and the
     render of the sharded chunk against the one-process render of it
     (y_sin 2e-4, y 2e-3); each rank's analysis and synthesis ms and
     peaks.  19b,
     batched_pipeline(mesh=) over the 128 x 8 s bench rows, 32 a rank:
     every rank's y rows and the gathered snr bit for bit the one-process
     batch's, mean_snr within 1e-5 dB; the step ms and the gather's bytes.
     19c, StreamPool(mesh=) with 64 streams over the 4 ranks as phase 15b:
     each rank holds its 16 streams to their solo renders bit for bit and
     every rank's streams are the same; ms a tick.  19d, at the default
     widths on phase 17c's normalized coder vectors: the AE on a (batch 2,
     model 2) tensor-parallel mesh against the data-parallel run and the
     one-process run (5-step losses, 2e-2 relative), the trunk over 4
     pipeline stages (forward within 2e-5 of forward_reference, 5 steps'
     losses 1e-4 relative of one process), the MoE over 4 expert ranks
     (forward within 2e-5 of moe_forward_reference); ms a step.  19e,
     19a's clean chunk saved by the 4 ranks with chunk_save_orbax (a
     torch.distributed.checkpoint directory) and loaded here: equal.  The
     ranks also report which collectives gloo ran on CUDA tensors itself
     (the meshes stage through the host those it refuses).
 20. the wide configurations (cell wide), past the first kernels' shape
     limits, each kernel held to its twin on the path's calls at 2 rows
     (phase 3's tolerances) and the counted run's launches checked.  20a,
     creaky voice's conf (tests/test_creaky.py: maxnhar=160, fnyq=6000)
     at phase 5's options on the 128 x 8 s bench rows: the denoiser's
     kernels at K = 160 (the wide denoise_stats and denoise_apply, the
     finish), harmonic_project_win (its groups of 80), deconv_full,
     osc_bank and noise_mod_ola launched; noisy rows 0/1 within 0.05 dB
     and clean row 64 at most 0.1 dB under the JAX package's values;
     every kernel of the run timed at full batch beside its bound (the wide
     denoise_apply also held to its twin there and printed with its
     geometry and ratio); rows 0 and 64 alone equal their batch rows as in
     phase 5.  20b, 48 kHz at a
     10 ms hop (tests/test_edgecases.py's conf at its sweep's hop: fnyq
     12000, chanfreq (3000, 6000, 9000), nspec 513) on the bench rows
     resampled to 48 kHz on the card (ops.resample.resample_to; every
     second F0 frame; 128 x 384000 samples): noise_mod_ola at nhop = 480
     (the wide kernel: its geometry, two blocks an SM, and at full batch
     its twin, time, bound and ratio), the pins, times and rows alone as
     20a.  20g, the same at a 20 ms hop (hop 960, every fourth F0 frame):
     noise_mod_ola's long kernel (the wide kernel's 16-frame block would
     not leave room for two an SM), held to its twin at full batch and timed
     beside its bound; the projection's main pass in the warp kernel (the
     16-frame tile's 145920 bytes would leave room for one block an SM),
     held to its twin at full batch and timed beside its bound; the cycle
     track past a 512-sample hop (its long-hop kernel) in the
     analysis and the synthesis, two launches, held to its twin at full
     batch there and timed beside its bound; pins from port_jax_pins.py
     only=h20, rows 0, 1 and 64 alone as 20a.  20h, the same at a 50 ms
     hop (hop 2400, every tenth F0 frame): the projection's two passes in
     the warp kernel (the main pass's 16-frame tile past shared memory, the
     envelope pass's one block an SM), the cycle
     track's hop kernel (past 2048 samples), noise_mod_ola's long kernel,
     each held to its twin at full batch and timed beside
     its bound; pins from only=h50, rows 0, 1 and 64 alone; then 96 kHz
     at a 200 ms hop (hop 19200) at kernel level on full-batch shapes:
     the projection past one frame's span (the warp kernel), the hop
     kernel at up to 200 cycles a hop, the long noise kernel
     (LONG_HOP_ROWS rows) and harmonic_project's row kernel (spans past
     its staged columns in chunks), each against its twin and beside its
     bound.  20c,
     denoise_stats on phase 5's full-batch call ([128, 1600, 80]) with the
     taps of a 2 ms hop (33 + 17) and of track_denoise_hz=5 at 5 ms (41 +
     21): the wide kernel against its twin.  20d, viterbi_scan against its
     twin, paths and last scores bit for bit, at S = 257 (renormalized),
     512 (not) and 1025 (renormalized) on seeded scores in eighths with
     -inf entries under the tracker's transitions at that S ([64, 1600,
     S], row 0 alone, rows 0 and 1 joined into one 3200-frame row), then
     at S = 2049 (renormalized) and 4097 (not), [64, 1600, S] and row 0
     alone; then the tracker with F0Config(nbins=384) and nbins=2048 on
     64 bench rows: one launch each, its call against the twin bit for
     bit, a finite track (S 257 to 2048 run viterbi.cu's grid kernel, past
     it its stream kernel), each case timed beside its bound.  20e, full band (maxnhar = fs / 2 /
     f0_floor at phase 5's options with f0_floor 40): 48 kHz at the 5 ms
     hop (K = 600, D = 11; the bench rows resampled on the card, every F0
     frame) and 16 kHz at a 2 ms hop (K = 200, D = 26, fnyq 8000; the
     bench rows made at that hop), each as 20a (launches, the kernels
     against their twins at 2 rows, pins, full-batch times, the step and
     its peak, rows 0 and 64 alone), deconv_full past its first kernel's
     shared memory (its wide path, checked by the geometry and K);
     deconv_full, denoise_stats and denoise_apply, whose wide paths were
     redesigned for the card, also held to their twins at full batch,
     each time beside its bound on a line of its own; the
     pins are the JAX package's with its windowed projection in float64
     (port_jax_pins.py only=proj64), noisy rows within 0.05 dB.  20f,
     at full batch against their twins: env_render at Ke 9 and 12, the
     cycle track at hops 960 and 2048 (48 kHz) and noise_mod_ola_seg at 9
     channels of 9 envelope harmonics.
Phases 5, 6, 7 and 9 also time every call of each of their kernels in
the counted run at full batch (median of 10, and a launch's share of a
run of 20 back-to-back launches: the device time where the host enqueues
faster than the card runs), beside its bound and, where one exists, its
PyTorch yardstick on the same inputs (where its operands do not fit in the
card's memory, timed on the first 1/2, 1/4, ... of the rows and scaled,
which the line says).  The line before the last is
the kernels' JSON summary: launches from the phase that runs each (5 for
the six, fir_frames, noise_bins, sample_cycles and refine_f0_dec, 6 for
harmonic_project_mxu, 7 for refine_f0_full and harmonic_project (0:
its K = 1 case is phase 3's), 9 for env_render and viterbi_scan, 16c
for noise_mod_ola_seg;
denoise_apply also "finish_launches" and "finish_full_batch" for its
second launch; "launches_by_phase" the counts of phases 11 to 17, of
19, summed over its ranks' 19a runs, and of 20a, 20b, 20d, 20e, 20g
and 20h); ms,
plain_ms, library_ms and bound_ms at the first 2-row call of phase 3
(noise_mod_ola_seg: its full-batch call of 16c; deconv_full_wide,
deconv_full's second path: 20e's first 2-row call, its launches those
of 20e's counted runs; denoise_stats_wide, denoise_stats's second path:
20a's first 2-row call, its cases and full-batch records 20a's, 20c's
and 20e's, its launches those of 20a's and 20e's counted runs;
harmonic_project_win_warp, sample_cycles_hop, noise_mod_ola_long and
harmonic_project_rows, the paths past the hop-dependent limits: 20h's
first case (noise_mod_ola_long's and harmonic_project_win_warp's: 20g's),
their launches those of 20h's counted run (the warp kernel's: 20g's
main pass and both of 20h's passes; noise_mod_ola_long's those of 20g's
and 20h's; 0 for harmonic_project_rows, which only the 96 kHz / 200 ms
shapes take);
viterbi_scan: 11v's
first case, phase 9's full-batch Rd call; denoise_stats also has
16b's full-batch polar case among its "cases"; phase 20's other cases
and full-batch records join each kernel's); "full_batch" a record per
call at full batch ("analysis_calls" on harmonic_project_win and
"render_calls" on osc_bank: phase 5's two harmonic_analysis calls and two
renders).  bound_ms is the larger of the bytes the
call must move (inputs read once, outputs written once; of the
pre-windowed frames of harmonic_project only the live columns) over 3.35
TB/s and its operations: float32 ones over 67 TFLOP/s (the H100 SXM data
sheet), the noise draw's integer ones over the 16.75 TOP/s of the SM's
INT32 lanes (a quarter of the float32 rate).
The last line is {"ok": true, "device": {...}}.  TF32 is off for every
float32 matmul and convolution.

The SNR, rd and PbP pins are the JAX package's own values on the CPU, from

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/port_jax_pins.py \
        [only=l0,11k,l1,pbp,corpus,edits,coder,nasal,stream,dspkit,
              learned,fp64,mesh,wide,h20,h50,proj64]

(l0: phases 4 and 5; 11k: phases 7 and 8; l1: phase 9; pbp: phase 10;
corpus: phase 11; edits: phase 12; coder: phase 13; nasal: phase 14;
stream: phase 15, ~1 min on the CPU; dspkit: phase 16, ~70 s; learned:
phase 17d-e and its npz, ~25 s; fp64: phase 18a, ~10 s; mesh: phase 19a,
~130 s; wide: phase 20a-b; h20 / h50: phases 20g / 20h, ~20 s each;
proj64: phase 20e, with the JAX package's windowed projection in float64,
~3 min).
"""
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

BATCH, DURATION, N_NOISY = 128, 8.0, 64
OFF_ROWS = list(range(16)) + list(range(N_NOISY, N_NOISY + 16))  # phase 4
CLEAN_MIN_DB = 55.17                      # JAX Pallas-branch reference: 55.27
NOISY_TOL_DB = 0.2
# phases 4-6: the card sits 0.017-0.022 dB above the JAX package on noisy
# rows 0/1 with the denoiser on, from float32 rounding in the analysis front
# end that the denoiser's gates amplify (scripts/port_card_vs_cpu.py,
# scripts/port_l0_parity.py; PERF.md section 7), within 2e-4 dB with it off
L0_NOISY_TOL_DB = 0.05
# the JAX package's own values at 16 kHz on the CPU, from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/port_jax_pins.py only=l0
# phases 4 and 5: batched_pipeline SNR of bench rows 0, 1 (noisy), and 64
# (clean) with the library default
NOISY_PINS_DB = {"denoiser off": {0: 32.69486618041992, 1: 33.14051818847656},
                 "library default": {0: 40.05961608886719,
                                     1: 40.60990905761719,
                                     64: 55.269065856933594}}
# the JAX package's own values at 11 kHz (Pallas kernels in interpret mode
# on the CPU), from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/port_jax_pins.py only=11k
# phase 7: batched_pipeline SNR of bench rows 0, 1 (noisy) and 64 (clean)
ODD_HOP_PINS_DB = {0: 38.74501419067383, 1: 38.651763916015625,
                   64: 54.44218826293945}
CLEAN_TOL_DB = 0.1
# phase 8: y_sin SNR of the 1 s rows of seeds 0 (noisy) and 64 (clean)
PUBLIC_11025_PINS_DB = {0: 36.86190946632691, 64: 46.70321121537888}
PUBLIC_TOL_DB = 0.1
# the JAX package's own values at 16 kHz on the CPU, from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/port_jax_pins.py only=l1
# phase 9: layer-1 round-trip y_sin SNR of bench rows 0, 1 (noisy), 64 (clean)
LAYER1_PINS_DB = {0: 40.059172572920154, 1: 40.609634863972815,
                  64: 55.24957249760942}
# phase 10: SNR of PbP y_sin against the layer-1 sinusoidal y_sin, LF rows
# 0 and 1 (PbP renders the LF x minimum-phase pulse and drops the measured
# phase residual vsphse, so the two waveforms are near-uncorrelated: a
# regression pin, not a quality figure)
PBP_PINS_DB = {0: 2.5078524906236277, 1: -3.4844267509230527}
# phase 10: median voiced rd of LF rows 0 and 1 after the library-default
# analysis and chunk_to_layer1 (Rd 0.4 and 1.0; the same script)
RD_PINS = {0: 0.41814684867858887, 1: 0.9919065237045288}
RD_PIN_REL_TOL = 0.01
# phase 11: the corpus from files (BASELINE config 5 on one card)
CORPUS_FILES, CORPUS_BATCH = 1000, 64
CORPUS_BUCKETS = (200, 400, 800, 1600)
CORPUS_ALONE = 3                          # tracked files also run alone
# the JAX package's run_corpus_files on the first 16 files (batch_size 8),
# from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/port_jax_pins.py only=corpus
# file -> (SNR dB, None for a sidecar file, else the JAX tracker's voicing
# over the file's bucket as run lengths, the first unvoiced)
CORPUS_PINS = {0: (30.440826416015625, None), 1: (42.857200622558594, None),
               2: (30.40850067138672, [0, 125, 6, 69]),
               3: (39.040592193603516, [0, 1471, 3, 126]),
               4: (29.94118881225586, None), 5: (56.96882629394531, None),
               6: (30.782182693481445, [0, 1505, 5, 90]),
               7: (40.14470672607422, [0, 105, 5, 90]),
               8: (30.116289138793945, None), 9: (49.6275749206543, None),
               10: (29.99997901916504, [0, 365, 4, 31]),
               11: (39.53449630737305, [0, 913, 4, 683]),
               12: (29.7045841217041, None), 13: (49.08095932006836, None),
               14: (29.98853302001953, [0, 287, 4, 109]),
               15: (39.314510345458984, [0, 1072, 6, 522])}
CORPUS_SIDECAR_TOL_DB = 0.05
# a tracked file's frames just past its end see a YIN span of zeros, where
# the CMNDF degenerates and the Viterbi meets near-ties: one frame there
# voiced differently (file 10, frame 368 of 400; the port on the CPU makes
# the same flip, so it is the two FFT libraries' rounding, not the card)
# moved that file's SNR 0.39 dB through the denoiser's frame filters
CORPUS_TRACKED_TOL_DB = 0.5
CORPUS_VOICING_MIN = 0.99                 # share of frames voiced alike
# phase 12: BASELINE config 4 on phase 10's LF rows 0 and 1, the JAX
# package's edited frame count, voiced median F0 and y_sin rms, from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/port_jax_pins.py only=edits
EDIT_PINS = {0: dict(nfrm=2400, f0_median=279.9015197753906,
                     rms=0.40369167166039716),
             1: dict(nfrm=2400, f0_median=279.93310546875,
                     rms=0.590258163325809)}
EDIT_F0_REL_TOL = 1e-4
EDIT_RMS_TOL_DB = 0.05
EDIT_DOUBLE_TOL = 0.01                    # every row's median F0 ratio, 2 +- 1%
# phase 13: the codec on phase 10's chunk; the JAX package's coder on LF
# rows 0 and 1 (a quantizer fitted on them), from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/port_jax_pins.py only=coder
# which writes its 8-bit archive to CODER_PINS: the y_sin rms of the float
# decode and the MCD of the 8-bit archive's decode against it
CODER_PINS = Path(__file__).resolve().parent / "scripts/port_jax_pins_coder.npz"
CODER_PINS_ROWS = {0: dict(rms=0.2683359187629238, mcd8=0.011305101071402146),
                   1: dict(rms=0.27372478295835223, mcd8=0.012717904687939914)}
# the card's rows 0/1 coded with the JAX archive's quantizer: codes equal
# to its codes in this share of slots, and the dequantized vectors within
# one quantizer step of its in this share.  The port's float vectors sit
# more than a step from the JAX package's in 0.05% of slots on the CPU
# too (ill-conditioned vtmagn and log-PSD bins, up to 7 steps), which the
# codes inherit: there 97.8% equal, 99.98% within a step
CODER_CODES_MIN = 0.96
CODER_STEP_SHARE_MIN = 0.999
CODER_RMS_TOL_DB = 0.05
CODER_MCD_TOL_DB = 0.1
# the synthesis kernels that decode -> synthesize must launch
CODEC_KERNELS = ("sample_cycles", "osc_bank", "noise_bins", "noise_mod_ola")
# phase 14: nasal rows (zero (900, 60) Hz, f0_base by row), the sections
# of tests/test_nasal.py, its floors on the median voiced rd, and the JAX
# package's medians of rows 0 and 1 with and without the sections, from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/port_jax_pins.py only=nasal
NASAL_F0 = (120.0, 182.0, 200.0)
NASAL_SECTIONS = ((250.0, 70.0, -1.0), (900.0, 60.0, 1.0))
NASAL_FLOORS = {120.0: (0.9, 1.15), 182.0: (0.8, 1.25), 200.0: (0.8, 1.25)}
NASAL_PINS = {0: dict(sections=0.9863114356994629, none=0.9919065237045288),
              1: dict(sections=1.0102050304412842, none=0.5516616106033325)}
# phase 15: streaming (cell stream-serve).  15a: RTAnalyzer with its
# default blocks on bench rows 0, 1 and 64; tests/test_rtanalyze.py's floors
# with the denoiser off; with it on the ampl SNR against the offline
# analysis with it off (>= 20 dB), and rows 0/1 against the offline
# analysis with it on within 0.5 dB of the JAX package's, from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/port_jax_pins.py only=stream
STREAM_BLOCK, STREAM_HALO = 64, 48
STREAM_ROWS = (0, 1, 64)
STREAM_SNR_FLOORS = {"ampl": 45.0, "psd": 35.0, "edc": 35.0, "eenv_a": 30.0}
STREAM_DENOISE_MIN_DB = 20.0
STREAM_PINS_DB = {0: 45.59350604145286, 1: 46.05091183924507}
STREAM_PIN_TOL_DB = 0.5
# 15b: scripts/bench_serve.py's default pool on the port's offline chunks of
# bench rows 0-31 and 64-95, fed 7 frames at a time (test_rtserve's drain);
# streams 0, 1 and 32 (bench rows 0, 1, 64) held to solo renders
POOL_STREAMS, POOL_BLOCK, POOL_FEED = 64, 16, 7
POOL_ROWS = list(range(32)) + list(range(N_NOISY, N_NOISY + 32))
POOL_SOLO = (0, 1, 32)
POOL_SNR_MIN_DB = 15.0                    # tests/test_runtime.py
FEED_TOL = 2e-5                           # feed against feed_many
# 15c: PbP serving of phase 10's LF rows 0-3, rows 0/1 against offline
# PbP within STREAM_PIN_TOL_DB of the JAX package's (only=stream: its
# test_runtime floor of 35 dB, set on a 0.6 s harmonic fixture, does not
# hold for the JAX package on 8 s LF rows: the offline render's float32
# time base drifts), and test_runtime's own fixture > 35 dB; 15d: the
# codec stream
PBP_POOL_STREAMS = 4                      # each checked against a solo run
PBP_STREAM_PINS_DB = {0: 28.15873515682718, 1: 28.73481982682412}
PBP_SNR_MIN_DB = 35.0                     # tests/test_runtime.py
CODEC_STREAM_MIN_DB = 25.0                # tests/test_coder.py
RD_CPU_REL_TOL = 1e-3                     # phase 10: card rd against the CPU
LF_RD = (0.4, 1.0, 1.8, 2.7)              # phase 10: true Rd of row i % 4
RD_REL_TOL = 0.15                         # tests/test_layer1.py's criterion
# H100 SXM data sheet: HBM rate and float32 rate outside the tensor cores
# (128 lanes an SM, an FMA counted as two); the SM's 64 INT32 lanes issue a
# quarter of that in integer operations
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12
INT32_OPS_PER_S = FP32_OPS_PER_S / 4
# kernel -> (source, TPU kernel it replaces, tolerance on max |error|); a
# string tolerance "rel x" is x times the largest |track| of the call's
# inputs (the denoiser's: test_pallas.py's 2e-3 x scale); a tuple is one
# absolute tolerance per output
KERNELS = {
    "harmonic_project_win": ("libllsm2_tpu_torch/csrc/harmonic_project_win.cu",
                             "libllsm2_tpu/ops/pallas_osc.py:254", 2e-3),
    "deconv_full": ("libllsm2_tpu_torch/csrc/deconv_full.cu",
                    "libllsm2_tpu/ops/pallas_osc.py:639", 5e-4),
    "osc_bank": ("libllsm2_tpu_torch/csrc/osc_bank.cu",
                 "libllsm2_tpu/ops/pallas_osc.py:112", 2e-4),
    "noise_mod_ola": ("libllsm2_tpu_torch/csrc/noise_mod_ola.cu",
                      "libllsm2_tpu/ops/pallas_osc.py:457", 5e-5),
    "denoise_stats": ("libllsm2_tpu_torch/csrc/denoise_stats.cu",
                      "libllsm2_tpu/ops/pallas_osc.py:1156", "rel 2e-3"),
    "denoise_apply": ("libllsm2_tpu_torch/csrc/denoise_apply.cu",
                      "libllsm2_tpu/ops/pallas_osc.py:1238", "rel 2e-3"),
    "harmonic_project_mxu": ("libllsm2_tpu_torch/csrc/harmonic_project_mxu.cu",
                             "libllsm2_tpu/ops/pallas_osc.py:786", "rel 2e-3"),
    "harmonic_project": ("libllsm2_tpu_torch/csrc/harmonic_project.cu",
                         "libllsm2_tpu/ops/pallas_osc.py:1388", 2e-3),
    "fir_frames": ("libllsm2_tpu_torch/csrc/fir_frames.cu",
                   "libllsm2_tpu/ops/pallas_osc.py:1315", "rel 1e-6"),
    "env_render": ("libllsm2_tpu_torch/csrc/env_render.cu",
                   "libllsm2_tpu/ops/pallas_osc.py:360", (2e-5, 2e-6)),
    # not a Pallas kernel: the port's counterpart of the jax.random draw
    # that XLA makes itself (fold_in / split / normal); the bits must be
    # equal, the normals within the tolerance
    "noise_bins": ("libllsm2_tpu_torch/csrc/noise_bins.cu",
                   "libllsm2_tpu/models/layer0.py:1163", 1e-6),
    # not a Pallas kernel: the cycle track (the JAX package's XLA scan);
    # wrapped |difference| in cycles
    "sample_cycles": ("libllsm2_tpu_torch/csrc/sample_cycles.cu",
                      "libllsm2_tpu/ops/harmonics.py:35", 1e-4),
    # not a Pallas kernel: the decimated F0 refine (the JAX package's jnp,
    # which XLA fuses); relative |error| of the F0 track, a frame voiced in
    # one and not the other an infinite one
    "refine_f0_dec": ("libllsm2_tpu_torch/csrc/refine_f0.cu",
                      "libllsm2_tpu/ops/harmonics.py:372", 1e-4),
    # the full-rate F0 refine: the K = 1 calls of harmonic_project_pallas
    # (JAX harmonics.py:494-543) and the framing around them, one launch;
    # relative |error| as refine_f0_dec's
    "refine_f0_full": ("libllsm2_tpu_torch/csrc/refine_f0.cu",
                       "libllsm2_tpu/ops/pallas_osc.py:1388", 1e-4),
    # not a Pallas kernel: both Viterbis, each a lax.scan forward and a
    # reverse lax.scan backtrace in the JAX package (the F0 tracker's and
    # layer 1's Rd path); a path that differs is an infinite error, then
    # the |difference| of the last scores
    "viterbi_scan": ("libllsm2_tpu_torch/csrc/viterbi.cu",
                     "libllsm2_tpu/ops/f0.py:213, "
                     "libllsm2_tpu/models/layer1.py:165", 0.0),
}
VITERBI = "viterbi_scan"
# phase 16: the segment-input entry of noise_mod_ola.cu (noise_idft="fft"),
# a wrapper of its own; source, TPU kernel it replaces, tolerance
SEG_KERNEL = ("libllsm2_tpu_torch/csrc/noise_mod_ola.cu",
              "libllsm2_tpu/ops/pallas_osc.py:457", 5e-5)
# the only kernels use_pallas=False launches (no Pallas twin: the JAX
# package draws the noise and sums the cycle track in jnp under both)
PLAIN_KERNELS = ("noise_bins", "sample_cycles")
# the JAX package's values with use_pallas=False on the CPU, from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/port_jax_pins.py only=dspkit
# phase 16a: batched_pipeline SNR of bench rows 0, 1 (noisy) and 64 (clean)
DSPKIT_PINS_DB = {0: 40.049285888671875, 1: 40.597862243652344,
                  64: 54.843502044677734}
# phase 16b: each analysis option with the kernels on (JAX: Pallas in
# interpret mode), rows 0 and 1
DSPKIT_OPTIONS = {"pp": dict(hm_method="pp"), "passes 2": dict(hm_passes=2),
                  "correction none": dict(hm_correction="none"),
                  "frame_chunk 64": dict(frame_chunk=64)}
DSPKIT_OPTION_PINS_DB = {
    "pp": {0: 28.651866912841797, 1: 28.702089309692383},
    "passes 2": {0: 40.068843841552734, 1: 40.620819091796875},
    "correction none": {0: 40.09574508666992, 1: 40.535396575927734},
    "frame_chunk 64": {0: 40.05961608886719, 1: 40.60990905761719}}
_RENDER = ("osc_bank", "harmonic_project_win", "denoise_stats",
           "denoise_apply", "noise_mod_ola")
DSPKIT_OPTION_KERNELS = {"pp": _RENDER, "passes 2": _RENDER,
                         "correction none": _RENDER,
                         "frame_chunk 64": _RENDER + ("deconv_full",)}
DSPKIT_STEP_REPS = 3              # 16a: median of 3 after a warm-up
DSPKIT_OPTION_REPS = 3
FRAME_CHUNK_TOL = 1e-6            # 16b: chunked / unchunked, of each field's peak
NOISE_IDFT_TOL = 1e-5             # 16c: y_nos rms error, of its rms
LEAF_TOL = 1e-4                   # 16d: card / CPU, of the output's peak
LEAF_CPU_ROWS = 8                 # 16d: rows run on the CPU where it is slow
# sample_cycles against its plain version run on the CPU, which sums in the
# kernel's order (a float64 running sum a hop): wrapped |difference|, cycles
SAMPLE_CYCLES_CPU_TOL = 1e-6
# phase 17 (cell tts-train-serve)
TTS_UTTS, TTS_FRAMES, TTS_STEPS = 24, 224, 400   # train_tts_demo's defaults
AE_LR, AE_STEPS = 3e-3, 100               # tests/test_neural.py's lr, steps
VQ_LR, VQ_STEPS = 2e-3, 220               # tests/test_vq.py's
LEARNED_PINS = (Path(__file__).resolve().parent
                / "scripts/port_jax_pins_learned.npz")
LEARNED_STEPS = 5                         # the losses the pins hold
LEARNED_FWD_TOL = 2e-2      # of scale: bfloat16 operands (tests' tolerance)
LEARNED_LOSS_RTOL = 2e-2    # tests/test_torch_learned.py's trajectories
LEARNED_TOKENS_MIN = 0.99
ABS_SNR_PIN_DB = 56.965209437981905       # JAX, test_abs's snr_after (CPU)
ABS_SNR_TOL_DB = 0.05       # the port on the CPU: 56.9643 (gap 0.0009 dB)
# phase 18 (cell cli-fp64)
FP64_SNR_PIN_DB = 56.320644984409434      # JAX float64, test_fp64 (CPU)
FP64_SNR_TOL_DB = 0.01
CLI_BATCH_FILES = 8
# phase 19 (cell multi-device): ranks of torch.distributed as child
# processes sharing the one card (gloo)
MESH_RANKS = 4
MESH_SECONDS = 64.0                       # 19a: 12800 frames, 3200 a rank
MESH_SEEDS = {0: 0.05, 64: 0.0}           # 19a: seed -> noise level
# the JAX package's round trip of 19a's utterances on the CPU, y_sin SNR
# against the clean part: (frame-sharded on 4 devices, one process), from
# scripts/port_jax_pins.py only=mesh.  Its sharded value sits 0.087 dB
# under its one-process one on the clean utterance (float32 cycle offsets
# and the refine's edge ringing, which the port's seqparallel repairs), so
# the port is held to the one-process value and to no less than the
# sharded one
MESH_PINS_DB = {0: (40.92445755004883, 40.92669677734375),
                64: (57.315425872802734, 57.402801513671875)}
MESH_PINS_SECONDS = 64.0                  # the utterances the pins hold
MESH_SNR_TOL_DB = 0.05
MESH_EDGE = 10                            # rows at each global edge
# tests/test_parallel.py's tolerances (ampl, the complex track and psd on
# rows [MESH_EDGE:-MESH_EDGE]; env_inner on rows [4:-4])
MESH_TOL = {"ampl": 2e-6, "cplx": 1e-5, "psd": 1e-5, "edc": 5e-3,
            "env": 8e-3, "env_inner": 1e-3, "y_sin": 2e-4, "y": 2e-3}
MESH_MEAN_TOL_DB = 1e-5
MESH_TRAIN_STEPS = 5
MESH_LOSS_RTOL = 2e-2                     # test_neural.py's TP against DP
MESH_PP_RTOL = 1e-4                       # test_pp_ep.py's
MESH_FWD_TOL = 2e-5
MESH_PP_ROWS, MESH_EP_ROWS = 4096, 1024   # 19d: coder vectors a batch
MESH_REPS = 3                             # 19a: kernel / twin timing reps
MESH_TIMEOUT_S = 600
MESH_FIELDS = ("f0", "ampl", "phse", "hm_mask", "psd", "edc", "eenv_a",
               "eenv_p")
# phase 20 (cell wide): the JAX package's batched_pipeline SNRs of bench
# rows 0, 1 (noisy) and 64 (clean) at creaky voice's conf and at 48 kHz with
# a 10 ms hop, from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/port_jax_pins.py only=wide
# and with a 20 ms hop (phase 20g) from only=h20, a 50 ms hop (20h) from
# only=h50
WIDE_PINS_DB = {"creaky": {0: 40.427391052246094, 1: 40.932682037353516,
                           64: 54.8484001159668},
                "48 kHz": {0: 38.91567611694336, 1: 39.449703216552734,
                           64: 48.93970489501953},
                "48 kHz 20 ms": {0: 33.830360412597656,
                                 1: 34.028926849365234,
                                 64: 36.950321197509766},
                # phase 20h, from only=h50: a 50 ms hop models the rows
                # poorly (13 dB), but the JAX package and the port alike
                "48 kHz 50 ms": {0: 13.207839965820312,
                                 1: 13.213396072387695,
                                 64: 13.241656303405762}}
# phase 20e (cell wide, full band): maxnhar = fs / 2 / f0_floor at phase
# 5's options with f0_floor 40 -> (create_aoptions keywords, the fixtures'
# hop), and the JAX package's batched_pipeline SNRs of bench rows 0, 1
# (noisy) and 64 (clean) there with its windowed harmonic projection
# computed in float64: the card's projection takes each harmonic's phase
# directly, where the JAX kernel's float32 rotation recurrence over K = 600
# harmonics moves the 48 kHz noisy rows by 0.13-0.14 dB (PERF.md §6), from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/port_jax_pins.py \
#       only=proj64
FULLBAND = {"48 kHz": (dict(fs=48000.0, f0_floor=40.0, maxnhar=600), 0.005),
            "16 kHz 2 ms": (dict(thop=0.002, f0_floor=40.0, maxnhar=200,
                                 fnyq=8000.0), 0.002)}
FULLBAND_PINS_DB = {"48 kHz": {0: 38.343997955322266, 1: 38.714813232421875,
                               64: 57.403690338134766},
                    "16 kHz 2 ms": {0: 39.95677947998047,
                                    1: 40.462425231933594,
                                    64: 64.54426574707031}}
# deconv_full's and denoise_stats's second paths (past their first
# kernels' limits), a record each of their own in the kernels line
DECONV_WIDE = "deconv_full_wide"
DENOISE_WIDE = "denoise_stats_wide"
# phase 20h: the paths past the hop-dependent shared-memory limits, a record
# each in the kernels line -> the wrapper that launches it
PROJ_WARP = "harmonic_project_win_warp"
PROJECT_ROWS = "harmonic_project_rows"
LONG_HOP = {PROJ_WARP: "harmonic_project_win",
            "sample_cycles_hop": "sample_cycles",
            "noise_mod_ola_long": "noise_mod_ola",
            PROJECT_ROWS: "harmonic_project"}
LONG_HOP_ROWS = 32            # 20h's 96 kHz / 200 ms noise case (its twin's
                              # [C, 19201, 38400] matrices: ~40 GB)
WIDE_TAPS = {"2 ms hop": (33, 17), "5 Hz at 5 ms": (41, 21)}   # 20c
WIDE_STATES = ((257, True), (512, False), (1025, True))        # 20d
# past 2048 states (the stream kernel): [64, 1600, S] and row 0 alone
WIDE_STREAM_STATES = ((2049, True), (4097, False))
WIDE_VITERBI_ROWS = 64
WIDE_TRACKER_NBINS = (384, 2048)
MAIN_SIX = tuple(KERNELS)[:6]     # the library-default path's CUDA kernels
# ... and its frame-axis FIR, noise draw, cycle track and F0 refine
MAIN = MAIN_SIX + ("fir_frames", "noise_bins", "sample_cycles",
                   "refine_f0_dec")
# denoise_apply's second launch (the finish after the spectral gate), a
# wrapper of its own in denoise_apply.cu, checked under denoise_apply
FINISH = "denoise_finish"
PATH = MAIN + (FINISH,)           # every wrapper the main path launches
# ... and those of its analysis (phase 14 synthesizes nothing)
ANALYSIS = tuple(k for k in PATH if k not in ("noise_mod_ola", "noise_bins"))
BATCH_ROWS = (0, 1, 64)           # phase 5: rows whose analysis and output
                                  # must not depend on the batch
# kernels held to their plain version at full batch as well (phases 5, 7;
# phase 20 adds those whose wide paths were redesigned for the card)
FULL_CHECKED = ("refine_f0_dec", "refine_f0_full")
# phase 5: the refine on row 0 alone and on its frames [a, b), a block of
# RTAnalyzer's 160 frames
REFINE_BLOCK = (800, 960)


class PhaseError(Exception):
    pass


def phase(name, ok, detail):
    print(f"phase {name}: {'ok' if ok else 'FAIL'} {detail}", flush=True)
    if not ok:
        raise PhaseError(f"{name}: {detail}")


def kernel_label(mangled):
    """'..._23proj_win_kernelILi16ELi5ELb0EEEv...' -> 'proj_win_kernel<16,5,0>'."""
    m = re.search(r"\d+([a-z_]+_kernel)(I(?:L[ib]\d+E)+E)?", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def cuda_ms(torch, fn, reps):
    """Median milliseconds of fn() over reps runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def track_scale(torch, name, args, kw, ref):
    """Largest |track| among a denoiser call's inputs; for the unframed
    projection, the largest |re + j im| of the plain version's output."""
    if name == "harmonic_project_mxu":
        return float(torch.max(torch.hypot(ref[0], ref[1])))
    if name == "fir_frames":
        return max(float(torch.max(torch.abs(v)))
                   for v in _tensors(torch, args[:1]))
    if name == "denoise_stats" and not kw.get("complex_input"):
        return float(torch.max(torch.abs(args[0])))
    if name == FINISH:                      # the aligned track, complex
        return float(torch.max(torch.abs(args[0])))
    return float(torch.max(torch.hypot(args[0], args[1])))


def max_err(torch, name, got, ref, scale=1.0, kw=None):
    """Max |error| of a kernel's outputs.  Complex (re, im) pairs count
    |delta re + j delta im|; the denoiser's powers (pp, |c_s|^2, |r|^2)
    count |delta| / scale and its unit rotation factors |delta| x scale,
    so every term is in track units; a flipped guard is an infinite
    error."""
    cplx = lambda a, b: float(torch.max(torch.hypot(a[0] - b[0], a[1] - b[1])))
    if name == "deconv_full":
        if not (kw or {}).get("return_complex", True):   # (|c|, angle c)
            got, ref = (torch.view_as_real(torch.polar(*v)).unbind(-1)
                        for v in (got, ref))
        return cplx(got, ref)
    if name == "sample_cycles":                     # mod 1, in cycles
        d = got.double() - ref.double()
        return float(torch.max(torch.abs(d - torch.round(d))))
    if name == VITERBI:                      # (path, last scores)
        if not torch.equal(got[0], ref[0]):
            return float("inf")
        # equal scores (-inf ones too) count 0
        return float(torch.max(torch.where(got[1] == ref[1], 0.0,
                                           torch.abs(got[1] - ref[1]))))
    if name in ("refine_f0_dec", "refine_f0_full"):  # relative, voiced frames
        if not torch.equal(got == 0, ref == 0):
            return float("inf")
        return float(torch.max(torch.abs(got - ref)
                               / torch.clamp(torch.abs(ref), min=1e-6)))
    if name == "harmonic_project_mxu":
        # wsum and xsum count relative to their own peak, in track units
        rel = lambda g, r: float(torch.max(torch.abs(g - r))
                                 / torch.clamp(torch.max(torch.abs(r)),
                                               min=1e-30))
        return max(cplx(got, ref), scale * rel(got[2], ref[2]),
                   scale * rel(got[3], ref[3]))
    if name == "denoise_stats":
        if not torch.equal(got[3], ref[3]):
            return float("inf")
        powers = max(float(torch.max(torch.abs(g - r)))
                     for g, r in zip(got[:3], ref[:3]))
        return max(powers / scale, cplx(got[4:6], ref[4:6]),
                   cplx(got[6:8], ref[6:8]))
    if name == "noise_bins":                 # (re, im, bits_re, bits_im)
        if not (torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])):
            return float("inf")
        got, ref = got[:2], ref[:2]
    if name in ("denoise_apply", FINISH):
        if got[0].is_complex():              # (a, full), aligned
            return max(float(torch.max(torch.abs(g - r)))
                       for g, r in zip(got, ref))
        return float(torch.max(torch.abs(torch.polar(*got)    # (ampl, phse)
                                         - torch.polar(*ref))))
    got = (got,) if torch.is_tensor(got) else got
    ref = (ref,) if torch.is_tensor(ref) else ref
    return max(float(torch.max(torch.abs(g - r))) for g, r in zip(got, ref))


def variants(torch, name, args, kw):
    """The non-default variants of a captured denoiser call."""
    if name == "denoise_apply":
        return [("spectral=False (polar)", args, dict(kw, spectral=False))]
    if name == "deconv_full":
        return [("polar", args, dict(kw, return_complex=False))]
    if name == "denoise_stats":
        ap = (torch.hypot(args[0], args[1]), torch.atan2(args[1], args[0]))
        return [("(ampl, phse) input", ap + tuple(args[2:]),
                 dict(kw, complex_input=False))]
    return []


def _tensors(torch, ts):
    """The tensors of ts, tuples and lists flattened."""
    for t in ts:
        if torch.is_tensor(t):
            yield t
        elif isinstance(t, (tuple, list)):
            yield from _tensors(torch, t)


def _nbytes(torch, ts):
    """Bytes of the tensors; a leading axis of stride 0 (one draw expanded
    to the batch) counts once."""
    def stored(t):
        while t.dim() and t.stride(0) == 0:
            t = t[0]
        return t
    return sum(stored(t).numel() * t.element_size()
               for t in _tensors(torch, ts))


def _shapes(torch, args):
    return [tuple(t.shape) for t in _tensors(torch, args)]


def kernel_ops(torch, name, args, kw):
    """float32 operations one call needs on these inputs (a complex
    rotate-and-accumulate step counts 10; the denoiser's per-slot fit ~40),
    counting only live harmonics and columns where the inputs say so."""
    a = args
    if name == "osc_bank":                   # cyc, ampl, phse, mask, nhop
        # a sample of hop block i sums frames i and i + 1 (the last block
        # frame N - 1 alone): one rotation z^{k+1} a harmonic serves both (a
        # complex product, 6), each frame's live harmonic adds 2 FMAs (4)
        K = a[3].shape[-1]
        kslots = torch.arange(1, K + 1, device=a[3].device)
        kl = torch.amax(kslots * (a[3] > 0), dim=-1).double()  # live + 1
        kn = torch.nn.functional.pad(kl[..., 1:], (0, 1))
        return a[4] * float((6.0 * torch.maximum(kl, kn)
                             + 4.0 * (kl + kn)).sum())
    if name == "noise_bins":                 # seed, frame_base, B, N, nbin
        return 2 * 40.0 * a[3] * a[4]        # two normals of ~40 a bin
    if name in ("harmonic_project_win", "harmonic_project"):
        R, W = a[0].shape
        K = a[3] if name == "harmonic_project_win" else a[2]
        lo, hi = ((a[4], a[5]) if name == "harmonic_project_win"
                  else (a[3] if len(a) > 3 else None,
                        a[4] if len(a) > 4 else None))
        if lo is None:
            return 10.0 * R * W * K
        kl = kw.get("kl")
        live = kl.float() if kl is not None else float(K)
        return 10.0 * float(((hi - lo).float() * live).sum())
    if name == "harmonic_project_mxu":       # x, cyc, hw, K, nhop, hh
        # the banded product W G: 2 FMAs (4) a window sample a column pair
        # (the K harmonics, the ones and x); G: a complex product and two
        # multiplies by x (8) a harmonic a sample of the signal; the centre
        # rotation (6) a harmonic a frame
        reach = a[5] * a[4]
        span = torch.clamp(2 * torch.ceil(a[2]) + 1, max=2 * reach + 1)
        B, N = a[2].shape
        return (4.0 * (a[3] + 1) * float(span.sum())
                + 8.0 * a[3] * a[0].numel() + 6.0 * a[3] * B * N)
    if name == "deconv_full":   # ampl, phse, cyc, hw, mask, D, nhop, stride
        # a slot: the banded step (2D+1 taps x 6 FMAs, 12 a tap), the
        # input's c_{k+1} +- c_{k-1} (4 adds, once a slot: every tap that
        # reaches it shares them), its alignment and un-alignment (a sincos
        # and a complex product each, 2 x 20), the mask (2) and for the
        # polar track sqrt + atan2 (30); a frame: the taps (10 a tap a
        # point) and the quadrature field (a sincos a point, 20)
        B, N, K = a[0].shape
        band, nq = 2 * a[5] + 1, 2 * a[6] // a[7]
        slot = 12.0 * band + 46.0 + (0.0 if kw.get("return_complex", True)
                                     else 30.0)
        return float(B * N) * (K * slot + nq * (10.0 * band + 20.0))
    if name == "env_render":
        # a sample: one sincospif (20) and Ke - 1 rotations (6) shared by
        # the channels; a channel: the edc and base lerps (4), the two max
        # (2) and a harmonic's two lerps and two FMAs (8)
        B, N, C, Ke = a[2].shape
        return float(a[0].numel()) * (20.0 + 6.0 * (Ke - 1)
                                      + C * (8.0 * Ke + 6.0))
    if name == "noise_mod_ola":  # cyc, edc, ar, ai, base, re, im, gain, bands
        # the band iDFT: a segment's samples t and nhop + t share one even
        # and one odd sum over the band's bins ((-1)^k e^{2 pi j k t / T}),
        # so nhop samples a frame, 2 FMAs a live bin (a bin in a band); the
        # shaping, 3 a bin a frame; the envelope render and modulation, a
        # rotation ladder a channel: C (16 Ke + 13) a sample
        B, N, C, Ke = a[2].shape
        live = sum(hi - lo for lo, hi in zip(a[8][::2], a[8][1::2]))
        nhop = a[7].shape[-1] - 1
        return (float(B * N) * (nhop * live * 4.0 + 3.0 * a[7].shape[-1])
                + float(a[0].numel()) * C * (16.0 * Ke + 13.0))
    if name == "noise_mod_ola_seg":          # cyc, edc, ar, ai, base, segs
        # a sample: one sincospif (20); a channel: the envelope's lerps and
        # rotation ladder (8 Ke + 4), the OLA add, the base lerp, the max,
        # divide and FMA (6)
        C, Ke = a[2].shape[-2:]
        return float(a[0].numel()) * (20.0 + C * (8.0 * Ke + 10.0))
    if name == "sample_cycles":              # f0, nhop, fs, nx
        # a sample: its position, lerp and division (8), the offset's add and
        # mod 1 (3), the within-hop running sum's float64 add (2: the H100's
        # float64 rate is half its float32 rate)
        return 13.0 * (a[0].numel() // a[0].shape[-1]) * a[3]
    if name == "refine_f0_dec":              # x, f0, taps; D, ..., window
        # the FIR: an FMA a tap an output; a voiced frame (the others write
        # 0): each of its iters iterations takes, a column of its window's
        # support (|noff| <= hw: 2 floor(hw) + 1 columns, hw from the input
        # F0), the window (4, each cosine term 22; mltsine one sine), the
        # phase mod 1 (3) and its sincos (20) once for both probes, and two
        # FMAs a probe (4 each); the last iteration's double angle 8 more
        from libllsm2_tpu_torch.ops.kernels import _refine_dims
        from libllsm2_tpu_torch.ops.windows import COSINE_SERIES
        x, f0 = a[0], a[1]
        dm = _refine_dims(x.shape[-1], kw["D"], kw["nhop"], kw["fs"],
                          kw["halfwin_max"])
        terms = len(COSINE_SERIES.get(kw["window"], (0, 0))) - 1
        column = 4.0 + 22.0 * terms + 3.0 + 20.0 + 2 * 4.0
        f0v = f0[f0 > 0].double()
        hw = torch.clamp(kw["rel_winsize"] * dm["fs_d"] / (2.0 * f0v), 2.0,
                         float(dm["H_d"]))
        support = float(torch.clamp(2 * torch.floor(hw) + 1,
                                    max=dm["Wf"]).sum())
        return (2.0 * len(a[2]) * x.shape[0] * dm["nxd"]
                + support * (kw["iters"] * column + 8.0))
    if name == "refine_f0_full":             # x, f0; nhop, ..., window
        # no FIR; a voiced frame (the others write 0): each of its iters
        # iterations takes, a column of its support (2 floor(hw) + 1
        # columns, as the kernel walks them; hw from the input F0, which the
        # refine moves by at most max_rel_dev and 1 Hz), the window (4, each
        # cosine term 22; mltsine one sine), the phase mod 1 (3) and its
        # sincos (20) once for both probes, and two FMAs a probe (4 each);
        # the gate the same column for its one probe at 2 f0
        from libllsm2_tpu_torch.ops.windows import COSINE_SERIES
        terms = len(COSINE_SERIES.get(kw["window"], (0, 0))) - 1
        column = 4.0 + 22.0 * terms + 3.0 + 20.0
        f0v = a[1][a[1] > 0].double()
        hw = torch.clamp(kw["rel_winsize"] * kw["fs"] / (2.0 * f0v), 2.0,
                         float(kw["halfwin_max"]))
        support = float((2 * torch.floor(hw) + 1).sum())
        return support * (kw["iters"] * (column + 8.0) + column + 4.0)
    if name == "denoise_stats":
        return float(a[0].numel()) * (4.0 * len(a[5]) + 4.0 * len(a[6]) + 40.0)
    if name == "denoise_apply":
        # a slot: the fit and gate (~40); the polar mode also un-aligns (a
        # sincos and a complex product, 20), takes sqrt and atan2 (30) and
        # masks (2)
        return float(a[0].numel()) * (40.0 if kw.get("spectral") else 92.0)
    if name == FINISH:
        # a slot: the delta's add (2), un-align (20), polar (30), mask (2)
        return float(a[0].numel()) * 54.0
    if name == "fir_frames":
        n = sum(v.numel() * (2 if v.is_complex() else 1)
                for v in _tensors(torch, a[:1]))
        return 2.0 * len(a[1]) * n
    if name == "viterbi_scan":               # obs, lt, renorm
        # each step, each (from, to) pair: the candidate's add and its
        # compare against the running maximum
        B, N, S = a[0].shape
        return 2.0 * B * (N - 1) * S * S
    raise KeyError(name)


def kernel_int_ops(name, args):
    """Integer operations one call needs beyond its float32 ones: the noise
    draw's threefry hashes (79 operations: 20 rounds of add, rotate and
    xor, and the key schedule), 3 a frame (fold_in and split) and one a
    normal, two normals a bin, and the 2 a normal that make its uniform;
    0 elsewhere."""
    if name == "noise_bins":                 # seed, frame_base, B, N, nbin
        N, nbin = args[3], args[4]
        return 79.0 * (3 * N + 2 * N * nbin) + 2 * 2.0 * N * nbin
    return 0.0


def kernel_bytes(torch, name, args, kw, out):
    """Bytes one call must move: every input read once (harmonic_project_
    win's x and cyc once a row, not once a frame), every output written
    once; of harmonic_project's pre-windowed [R, W] frames and cycle
    offsets only each row's live columns [lo, hi); viterbi_scan's
    backpointers (a byte each, two past 256 states) written once as
    well."""
    if name == "noise_bins":                 # two [N, nbin] draws, expanded
        return 2 * 4 * args[3] * args[4]
    if name == "sample_cycles":              # f0 read, [B, nx] written
        return _nbytes(torch, args[:1]) + _nbytes(torch, (out,))
    nbytes = _nbytes(torch, args) + _nbytes(torch, kw.values()) \
        + _nbytes(torch, (out,))
    if name == "harmonic_project" and len(args) > 4:
        lo, hi = args[3], args[4]
        R, W = args[0].shape
        nbytes -= 2 * 4 * (R * W - float((hi - lo).sum()))
    if name == "viterbi_scan":               # and the backpointers
        B, N, S = args[0].shape
        nbytes += B * (N - 1) * S * (1 if S <= 256 else 2)
    return nbytes


def bound(torch, name, args, kw, out):
    """-> (bound_ms, bound_by): the larger of the bytes the call must move
    (kernel_bytes) over the HBM rate and its operations, float32 ones over
    the float32 rate and integer ones over the INT32 rate, each taken
    alone (the two pipes issue side by side)."""
    nbytes = kernel_bytes(torch, name, args, kw, out)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(kernel_ops(torch, name, args, kw) / FP32_OPS_PER_S,
                kernel_int_ops(name, args) / INT32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_call(torch, name, args, kw):
    """The kernel's function in plain PyTorch around one library
    contraction or convolution, from the same inputs, or None where there
    is none: an einsum against the dense oscillator / chirp basis for the
    oscillator bank and the framed projections, one bmm of banded window
    rows for the unframed projection, conv1d with the fixed taps for
    fir_frames (a pair as one batch), one irfft of each band's masked
    spectra, then the segments' OLA, for the noise part.  The making of those operands
    (frames, basis, windows, layout) is part of the returned callable, so
    it is timed with the call."""
    import math
    F = torch.nn.functional
    from libllsm2_tpu_torch.ops.harmonics import win_frames
    from libllsm2_tpu_torch.ops.windows import window_centered
    frac = lambda v: v - torch.round(v)
    if name == "osc_bank":
        from libllsm2_tpu_torch.ops.harmonics import (frame_hops,
                                                      overlap_add_half)
        cyc, ampl, phse, mask, nhop = args[:5]
        x = args[5] if len(args) > 5 else kw.get("x")
        B, N, K = ampl.shape
        T = 2 * nhop
        kh = torch.arange(1, K + 1, device=cyc.device, dtype=cyc.dtype)
        w_ola = 0.5 - 0.5 * torch.cos(2 * math.pi * (torch.arange(
            T, device=cyc.device, dtype=cyc.dtype) + 0.5) / T)

        def call():
            dc = frame_hops(cyc, N, nhop, 1, mode="edge") \
                - cyc[..., ::nhop][..., :N, None]
            osc = torch.cos(2 * math.pi * frac(kh[:, None] * dc[..., None, :])
                            + phse[..., None])
            segs = torch.einsum("bnkt,bnk->bnt", osc, ampl * mask) * w_ola
            y = overlap_add_half(segs, nhop, cyc.shape[-1])
            return y if x is None else x - y
        return call
    if name in ("harmonic_project_win", "harmonic_project"):
        win = name == "harmonic_project_win"
        W = 2 * kw["center"] if win else args[0].shape[1]
        dev = args[0].device
        col = torch.arange(W, device=dev)
        K = args[3] if win else args[2]
        kh = torch.arange(1, K + 1, device=dev, dtype=torch.float32)
        one = torch.ones((), device=dev)

        def call():
            if win:
                x, cyc, hw, _, lo, hi = args
                frames, dc = win_frames(x, cyc, hw.shape[-1], kw["nhop"],
                                        kw["center"])
                xw = frames * window_centered(
                    kw.get("window", "hanning"),
                    (col - kw["center"]).to(dc.dtype)[None],
                    hw.reshape(-1, 1))
            else:
                dc, xw = args[:2]
                lo, hi = (args[3], args[4]) if len(args) > 4 else (0, W)
                lo = torch.as_tensor(lo, device=dev)
                hi = torch.as_tensor(hi, device=dev)
            xw = xw * ((col >= lo.reshape(-1, 1)) & (col < hi.reshape(-1, 1)))
            basis = torch.polar(one, -2 * math.pi * frac(kh[None, :, None]
                                                         * dc[:, None]))
            return torch.einsum("nkw,nw->nk", basis, xw.to(basis.dtype))
        return call
    if name == "harmonic_project_mxu":
        x, cyc, hw, K, nhop, hh = args
        B, nx = x.shape
        N = hw.shape[-1]
        off = (torch.arange(nx, device=x.device)[None, :]
               - torch.arange(N, device=x.device)[:, None] * nhop)
        kh = torch.arange(1, K + 1, device=x.device, dtype=x.dtype)

        def call():
            w = window_centered(kw.get("window", "hanning"),
                                off.to(x.dtype)[None],
                                hw[..., None]) * (off.abs() <= hh * nhop)
            ang = 2 * math.pi * frac(kh * cyc[..., None])
            G = torch.cat([torch.ones_like(x)[..., None], x[..., None],
                           x[..., None] * torch.cos(ang),
                           -x[..., None] * torch.sin(ang)], dim=-1)
            return torch.bmm(w, G)
        return call
    if name == "fir_frames":
        vs, taps = list(_tensors(torch, args[:1])), args[1]
        B, N = vs[0].shape[:2]
        wt = torch.tensor(taps, dtype=torch.float32,
                          device=vs[0].device).reshape(1, 1, -1)
        cols = lambda v: (torch.view_as_real(v) if v.is_complex() else v
                          ).reshape(B, N, -1).permute(0, 2, 1).reshape(-1, N)
        return lambda: F.conv1d(torch.cat([cols(v) for v in vs])[:, None],
                                wt, padding=len(taps) // 2)
    if name == "noise_mod_ola":
        from libllsm2_tpu_torch.ops.harmonics import overlap_add_half
        from libllsm2_tpu_torch.ops.kernels import env_render_ref
        cyc, edc, ar, ai, base, re, im, gain, bands = args
        nbin = gain.shape[-1]
        nhop, C = nbin - 1, edc.shape[-1]
        T = 2 * nhop
        k = torch.arange(nbin, device=cyc.device)
        masks = torch.stack([(k >= lo) & (k < hi) for lo, hi in
                             zip(bands[::2], bands[1::2])]).to(cyc.dtype)
        w = torch.sqrt(0.5 - 0.5 * torch.cos(2 * math.pi * (torch.arange(
            T, device=cyc.device, dtype=cyc.dtype) + 0.5) / T))
        sc = torch.full((nbin,), math.sqrt(T / 2.0), device=cyc.device)
        sc[0] = sc[-1] = math.sqrt(float(T))

        def call():
            # each band's segments by one irfft of its masked spectra
            spec = torch.complex(re * sc, im * sc) * gain
            segs = torch.fft.irfft(spec[:, None] * masks[:, None], n=T) * w
            env, base_s = env_render_ref(cyc, edc, ar, ai, base, nhop)
            return sum(overlap_add_half(segs[:, c], nhop, cyc.shape[-1])
                       * (env[:, c] / base_s[:, c]) for c in range(C))
        return call
    return None


def check_kernel(torch, kernels, name, tol, args, kw, label, library=False,
                 prefix="3", reps=10):
    """Kernel against its plain version on one call's inputs -> case (with
    the bound and, if library, the one-call PyTorch yardstick's time); the
    phase line is "{prefix} name[label]", each time the median of reps."""
    fn = getattr(kernels, name)
    ref_fn = getattr(kernels, name + "_ref")
    # the noise draw is compared on its bits too
    cmp_kw = dict(kw, bits=True) if name == "noise_bins" else kw
    got, ref = fn(*args, **cmp_kw), ref_fn(*args, **cmp_kw)
    torch.cuda.synchronize()
    extra = ""
    if name == "sample_cycles":
        # the kernel sums in the order of the plain version on the CPU:
        # held to it there, far inside the twin's float32 drift on the card
        cpu = ref_fn(args[0].cpu(), *args[1:], **cmp_kw)
        cpu_err = max_err(torch, name, got.cpu(), cpu)
        extra = (f" against the plain version on the CPU {cpu_err:.3e} (tol "
                 f"{SAMPLE_CYCLES_CPU_TOL})")
        if cpu_err > SAMPLE_CYCLES_CPU_TOL:
            phase(f"{prefix} {name}[{label}] on the CPU's order", False,
                  extra)
    if isinstance(tol, tuple):                # one tolerance per output
        errs = [float(torch.max(torch.abs(g - r))) for g, r in zip(got, ref)]
        err, ok = max(errs), all(e <= t for e, t in zip(errs, tol))
    else:
        scale = 1.0
        if isinstance(tol, str):
            scale = track_scale(torch, name, args, kw, ref)
            tol = float(tol.split()[1]) * scale
        err = max_err(torch, name, got, ref, scale, kw)
        ok = err <= tol
    ms = cuda_ms(torch, lambda: fn(*args, **kw), reps)
    plain_ms = cuda_ms(torch, lambda: ref_fn(*args, **kw), reps)
    bound_ms, bound_by = bound(torch, name, args, kw, got)
    library_ms = None
    if library:
        call = library_call(torch, name, args, kw)
        if call is not None:
            library_ms = cuda_ms(torch, call, 10)
            del call
            torch.cuda.empty_cache()
    shapes = _shapes(torch, args)
    lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
    phase(f"{prefix} {name}[{label}]", ok,
          f"shapes {shapes[:2]} max_abs_err {err:.3e} (tol {tol}){extra} "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library {lib} "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"call": label, "shapes": shapes[:2], "max_abs_err": err,
            "tol": tol, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def full_batch(torch, kernels, calls, label, checked=FULL_CHECKED):
    """Every captured call of each kernel at full batch, timed alone
    (median of 10) beside its bound and, where one exists, its PyTorch
    yardstick (library_call) on the same inputs: where the yardstick's
    operands do not fit in the card's memory it runs on the first half,
    quarter, ... of the rows and its time is scaled by the fraction left
    out; fir_frames also beside its host path; the kernels in `checked`
    held to their plain versions as well -> {name: [record per call]}."""
    out = {}
    for name in calls:
        fn = getattr(kernels, name)
        out[name] = []
        for i, (args, kw) in enumerate(calls[name]):
            got = fn(*args, **kw)
            full_err = None
            if name in checked:
                # its twin fits at full batch: held to it there too
                tol, scale = KERNELS[name][2], 1.0
                ref = getattr(kernels, name + "_ref")(*args, **kw)
                if isinstance(tol, str):
                    scale = track_scale(torch, name, args, kw, ref)
                    tol = float(tol.split()[1]) * scale
                full_err = max_err(torch, name, got, ref, scale, kw=kw)
                del ref
                phase(f"{label} {name}[{i}] at full batch", full_err <= tol,
                      f"shapes {_shapes(torch, args)[:2]} against its plain "
                      f"version: max err {full_err:.3e} (tol {tol})")
            ms = cuda_ms(torch, lambda: fn(*args, **kw), 10)
            run = run_ms(torch, lambda: fn(*args, **kw), 20)
            bound_ms, bound_by = bound(torch, name, args, kw, got)
            del got
            library_ms, scale = library_full(torch, name, args, kw)
            host_ms = None
            extra = ""
            if library_ms is not None:
                extra = f" library {library_ms:.4f} ms" + (
                    "" if scale == 1 else f" (timed on 1/{scale} of the rows, "
                    f"x{scale}: its operands do not fit at full batch)")
            elif scale == 0:
                extra = " library: its operands do not fit even at one row"
            if name == "fir_frames":
                host_ms = host_call_ms(torch, lambda: fn(*args, **kw), 50)
                extra = f" (host path {host_ms:.4f} ms a call)" + extra
            shapes = _shapes(torch, args)
            print(f"full batch {label} {name}[{i}]: shapes {shapes[:2]} "
                  f"kernel {ms:.4f} ms{extra} bound {bound_ms:.4f} ms "
                  f"({bound_by}); {run:.4f} ms a launch in a run of 20",
                  flush=True)
            out[name].append({"phase": label, "call": i,
                              "shapes": shapes[:2], "ms": ms, "run_ms": run,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "library_ms": library_ms,
                              "library_row_fraction": None if not scale
                              or library_ms is None else 1.0 / scale,
                              "host_ms": host_ms,
                              "max_abs_err": full_err})
    torch.cuda.empty_cache()
    return out


def _first_rows(torch, v, part):
    """v with each tensor cut to the first 1/part of its leading axis
    (tuples and lists inside cut too)."""
    if torch.is_tensor(v):
        return v[:v.shape[0] // part] if v.dim() else v
    if isinstance(v, (tuple, list)):
        return type(v)(_first_rows(torch, u, part) for u in v)
    return v


def library_full(torch, name, args, kw):
    """-> (ms, scale): the PyTorch yardstick of one call at full batch
    (median of 10), or where it runs out of device memory on the first
    1/scale of the rows (scale 2, 4, ...: every input's leading axis cut
    alike), its time times scale; (None, 1) where there is none, (None,
    0) where even one row's operands do not fit the card (the projection's
    [N, K, 2 center] basis at full band: 34 GiB a row at 48 kHz, K =
    600)."""
    scale = 1
    while True:
        part_args = _first_rows(torch, args, scale)
        part_kw = {k: _first_rows(torch, v, scale) for k, v in kw.items()}
        ms = None
        try:
            call = library_call(torch, name, part_args, part_kw)
            if call is None:
                return None, 1
            ms = cuda_ms(torch, call, 10)
        except torch.cuda.OutOfMemoryError:
            lead = min(t.shape[0] for t in _tensors(torch, args) if t.dim())
            if lead // (2 * scale) < 1:
                call = None
                torch.cuda.empty_cache()
                return None, 0
        call = None
        torch.cuda.empty_cache()    # after the handler: its frames are gone
        if ms is not None:
            return ms * scale, scale
        scale *= 2


def run_ms(torch, fn, reps):
    """Milliseconds a call of fn in a run of reps back-to-back calls (CUDA
    events around the run, best of 3 runs): the device's time where the
    device, not the host's enqueue, is the slower."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def host_call_ms(torch, fn, reps):
    """Host milliseconds one call of fn takes to return (its enqueue: the
    Python wrapper and the launch, no synchronisation), mean of reps."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def synced_ms(torch, fn, reps):
    """Milliseconds of fn() from a synchronized start to a synchronized end
    on the host's clock, median of reps."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def peak_above(torch, fn):
    """-> (fn(), the peak device memory fn takes above what was allocated
    when it started, GiB)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**30


def analysis_calls(torch, harmonics, run):
    """The harmonic_analysis calls of one run() (phase 5: the K = 80 main
    pass and the K = 4 envelope pass), each timed alone at full batch
    (median of 10), framing, window, projection and glue included, with
    the device memory it takes above what it is given -> [record]."""
    calls, _ = capture_kernel_inputs(harmonics, ("harmonic_analysis",), run)
    out = []
    for i, (args, kw) in enumerate(calls["harmonic_analysis"]):
        call = lambda: harmonics.harmonic_analysis(*args, **kw)
        ms = cuda_ms(torch, call, 10)
        extra = peak_above(torch, call)[1]
        print(f"5 analysis call {i}: harmonic_analysis K {kw['max_k']} on x "
              f"{tuple(args[0].shape)}, cyc {tuple(args[2].shape)}: "
              f"{ms:.4f} ms (framing, window, projection and glue; median "
              f"of 10), {extra:.3f} GiB above its inputs", flush=True)
        out.append({"call": i, "max_k": kw["max_k"],
                    "x": tuple(args[0].shape), "ms": ms, "extra_gib": extra})
    del calls
    torch.cuda.empty_cache()
    return out


def render_hook(harmonics, kernels):
    """(module, name) of the function that renders the harmonic part: the
    one-launch kernels.osc_bank(cyc, ..., nhop, x), or on a package whose
    osc_bank takes frame offsets (the parent's) harmonics.oscillator_bank,
    whose segments overlap_add_half adds."""
    import inspect
    if "nhop" in inspect.signature(kernels.osc_bank).parameters:
        return kernels, "osc_bank"
    return harmonics, "oscillator_bank"


def render_calls(torch, harmonics, kernels, run):
    """The harmonic renders of one run() (phase 5: the analysis residual and
    the synthesis), each timed alone at full batch (median of 10) with the
    device memory it takes above what it is given -> [record].  Each is one
    osc_bank call (one launch); on the parent's package it is
    oscillator_bank + overlap_add_half, and the residual's x - y (cyc
    standing in for x)."""
    mod, name = render_hook(harmonics, kernels)
    new = mod is kernels
    calls, _ = capture_kernel_inputs(mod, (name,), run)
    out = []
    for i, (args, kw) in enumerate(calls[name]):
        resid = (len(args) > 5 and args[5] is not None) if new else i == 0
        if new:
            call = lambda: kernels.osc_bank(*args, **kw)
        else:
            nhop, nx = kw["nhop"], args[0].shape[-1]

            def call():
                y = harmonics.overlap_add_half(
                    harmonics.oscillator_bank(*args, **kw), nhop, nx)
                return args[0] - y if resid else y
        what = "residual" if resid else "synthesis"
        ms = cuda_ms(torch, call, 10)
        extra = peak_above(torch, call)[1]
        print(f"5 render call {i} ({what}): {name} on cyc "
              f"{tuple(args[0].shape)}, K {args[1].shape[-1]}: {ms:.4f} ms "
              f"(framing, coefficients, window and OLA included; median of "
              f"10), {extra:.3f} GiB above its inputs", flush=True)
        out.append({"call": i, "what": what, "fn": name, "ms": ms,
                    "extra_gib": extra})
    del calls
    torch.cuda.empty_cache()
    return out


def run_path(torch, kernels, corpus, label, opt, sopt, data, pins, need,
             timed, clean_min=CLEAN_MIN_DB, noisy_tol=NOISY_TOL_DB,
             checked=FULL_CHECKED):
    """Drive batched_pipeline once with the launch counters zeroed just
    before and read just after, capturing the inputs of the kernels in
    `timed`; check the kernels in `need` launched, the output and the SNR
    pins (noisy rows within noisy_tol of theirs, clean rows at most
    CLEAN_TOL_DB under theirs, the clean mean >= clean_min unless None);
    time each `timed` kernel at full batch on its first call (full_batch,
    holding those in `checked` to their plain versions there);
    then, after one untimed step, the step time (median of 5) and peak
    memory.  -> (the launch
    counts, the per-row SNRs, the full-batch records)."""
    x, f0, x_ref, nxv = data
    B = x.shape[0]
    kernels.reset_launches()
    calls, (y, snr, _) = capture_kernel_inputs(
        kernels, timed,
        lambda: corpus.batched_pipeline(opt, sopt, x, f0, nxv, x_ref))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    phase(f"{label} launches", all(launches[k] > 0 for k in need),
          str(launches))
    phase(f"{label} output", tuple(y.shape) == tuple(x.shape)
          and bool(torch.isfinite(y).all()), f"y {tuple(y.shape)} finite")
    snr = snr.cpu().tolist()
    check_snr(label, snr, pins, clean_min, noisy_tol)
    del y
    full = full_batch(torch, kernels, calls, label.split()[0], checked)
    del calls
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # one step first: the yardsticks above emptied the allocator's cache,
    # and the first step after that refills it from cudaMalloc
    corpus.batched_pipeline(opt, sopt, x, f0, nxv, x_ref)
    torch.cuda.synchronize()
    steps = []
    for _ in range(5):
        t0 = time.perf_counter()
        corpus.batched_pipeline(opt, sopt, x, f0, nxv, x_ref)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    step = statistics.median(steps)
    phase(f"{label} step", True,
          f"{B} x {DURATION} s: median {step * 1e3:.2f} ms of "
          f"{[round(t * 1e3, 2) for t in steps]} ms; "
          f"{B * DURATION / step:.1f} audio-sec/s; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, snr, full


def check_snr(label, snr, pins, clean_min, noisy_tol=NOISY_TOL_DB):
    """Per-row SNR checks of a bench batch (noisy rows first, then clean):
    the clean mean >= clean_min unless None, noisy pinned rows within
    noisy_tol, clean pinned rows at most CLEAN_TOL_DB under."""
    n_noisy = len(snr) // 2
    clean = statistics.fmean(snr[n_noisy:])
    phase(f"{label} clean snr", clean_min is None or clean >= clean_min,
          f"mean {clean:.4f} dB over {len(snr) - n_noisy} clean rows "
          f"(min {min(snr[n_noisy:]):.4f}; pin >= {clean_min})")
    for row, pin in pins.items():
        if row < n_noisy:
            phase(f"{label} noisy snr row {row}",
                  abs(snr[row] - pin) <= noisy_tol,
                  f"{snr[row]:.6f} dB (pin {pin} +- {noisy_tol})")
        else:
            phase(f"{label} clean snr row {row}",
                  snr[row] >= pin - CLEAN_TOL_DB,
                  f"{snr[row]:.4f} dB (pin {pin} - {CLEAN_TOL_DB})")
    print(f"{label}: noisy rows mean snr {statistics.fmean(snr[:n_noisy]):.4f}"
          f" dB over {n_noisy} rows", flush=True)


def fixtures(torch, dev, fs=16000.0, thop=0.005):
    """The bench fixtures at rate fs and F0 hop thop (bench.py's rows):
    rows [0, N_NOISY) with breath noise 0.05, the rest clean; the harmonic
    part, which no row's seed changes, is synthesized once (numpy,
    float64)."""
    import numpy as np

    from libllsm2_tpu_torch.utils import testsig
    rows = testsig.make_test_utterances(
        [(i, 0.05 if i < N_NOISY else 0.0) for i in range(BATCH)],
        duration=DURATION, fs=fs, thop=thop)
    x, f0, x_ref = (torch.tensor(np.stack([r[j] for r in rows]),
                                 dtype=torch.float32, device=dev)
                    for j in range(3))
    nxv = torch.full((BATCH,), x.shape[1], dtype=torch.int64, device=dev)
    return x, f0, x_ref, nxv


def _lf_utterance(i):
    from libllsm2_tpu_torch.utils import testsig
    nfrm = int(round(DURATION / 0.005))
    return testsig.synth_lf_speech(testsig.make_f0_track(nfrm, 0.005),
                                   rd=LF_RD[i % len(LF_RD)], seed=i)


def lf_fixtures(torch, dev):
    """Phase 10's LF rows, made here (numpy, scipy and the port's LF model
    on the CPU: ~30 ms a row) -> (x, f0)."""
    import numpy as np
    rows = [_lf_utterance(i) for i in range(BATCH)]
    return tuple(torch.tensor(np.stack([r[j] for r in rows]),
                              dtype=torch.float32, device=dev)
                 for j in range(2))


def snr_rows(torch, ref, y, fs, f0_floor):
    """snr_db of every row of a batch -> list."""
    return [snr_db(torch, ref[b], y[b], fs, f0_floor)
            for b in range(ref.shape[0])]


def staged(torch, stages):
    """Run the (name, fn) stages in order, each fed the previous result,
    with a synchronized host timer around each -> (result, {name: ms})."""
    out, ms = None, {}
    for name, fn in stages:
        t0 = time.perf_counter()
        out = fn(out)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
    return out, ms


def median_stages(torch, stages, reps):
    """Stage times (median of reps) and the peak memory of those runs."""
    torch.cuda.reset_peak_memory_stats()
    runs = [staged(torch, stages)[1] for _ in range(reps)]
    return ({k: statistics.median(r[k] for r in runs) for k in runs[0]},
            torch.cuda.max_memory_allocated() / 2**30)


def rows_alone(torch, stages, inp, rows=BATCH_ROWS):
    """A chain of (name, fn) stages, fn(input) -> (the next stage's input,
    {output: tensor}), run twice on the whole batch and on each of `rows`
    alone (a batch of one fed that row of the batch's input, so that a
    difference names its stage) -> ({stage: {output: max |alone - in the
    batch| over the rows, 0 where bit-equal, inf where unequal without a
    finite difference}}, {stage: the two runs of the batch equal})."""
    diff, same = {}, {}
    for name, fn in stages:
        nxt, whole = fn(inp)
        _, again = fn(inp)
        same[name] = all(torch.equal(whole[k], again[k]) for k in whole)
        diff[name] = dict.fromkeys(whole, 0.0)
        for r in rows:
            one = inp.map(lambda a: a[r:r + 1]) if hasattr(inp, "map") \
                else inp[r:r + 1]
            for k, v in fn(one)[1].items():
                if not torch.equal(v[0], whole[k][r]):
                    d = float((v[0].double() - whole[k][r].double())
                              .abs().max())
                    diff[name][k] = max(diff[name][k],
                                        d if d > 0 else math.inf)
        del whole, again
        inp = nxt
    torch.cuda.synchronize()
    return diff, same


def check_rows(label, diff, same, strict=True):
    """Report rows_alone: a phase line (failing unless every output is
    bit-equal and every stage's two runs equal), or with strict=False
    only a printed line."""
    ok = all(v == 0.0 for d in diff.values() for v in d.values()) \
        and all(same.values())
    detail = (f"rows {list(BATCH_ROWS)} alone (a batch of one) against the "
              f"{BATCH}-row batch, max |difference| by stage and output (0: "
              "bit for bit): " + "; ".join(
                  f"{s}: " + ", ".join(f"{k} {v:.3g}" for k, v in d.items())
                  for s, d in diff.items())
              + f"; two runs of the batch equal: {same}")
    if strict:
        phase(f"{label} rows alone = in the batch", ok, detail)
    else:
        print(f"{label} rows alone = in the batch: "
              f"{'equal' if ok else 'DIFFER'} {detail}", flush=True)


def fields(chunk, names):
    return chunk, {k: getattr(chunk, k) for k in names}


def outputs(res):
    return res, {k: getattr(res, k) for k in ("y", "y_sin", "y_nos")}


def layer1_stages(mods, sopt):
    """Phase 9's layer-1 chain as rows_alone stages."""
    from libllsm2_tpu_torch.container import LAYER1_FIELDS
    layer0, layer1 = mods[:2]
    return [("chunk_to_layer1",
             lambda c: fields(layer1.chunk_to_layer1(c), LAYER1_FIELDS)),
            ("chunk_to_layer0",
             lambda c: fields(layer1.chunk_to_layer0(c),
                              ("ampl", "phse", "hm_mask"))),
            ("synthesize", lambda c: outputs(layer0._synthesize(sopt, c)))]


def edit_stages(mods, sopt):
    """Phase 12's chain as rows_alone stages."""
    from libllsm2_tpu_torch.container import CHUNK_FIELDS
    layer0, edits = mods
    return [("pitch_shift",
             lambda c: fields(edits.pitch_shift(c, 2.0), CHUNK_FIELDS)),
            ("time_stretch",
             lambda c: fields(edits.time_stretch(c, 1.5), CHUNK_FIELDS)),
            ("synthesize", lambda c: outputs(layer0.synthesize_batch(sopt,
                                                                     c)))]


def layer1_round_trip(torch, kernels, mods, opt, sopt, data):
    """Phase 9: the library-default analysis -> chunk_to_layer1 ->
    chunk_to_layer0 -> _synthesize on the bench rows -> (the layer-0
    chunk, launches, the first viterbi_scan call's (args, kw))."""
    layer0, layer1 = mods
    x, f0, x_ref, _ = data
    B = x.shape[0]
    conf = opt.conf
    chunk0 = {}

    def analysis(_):
        chunk0["c"] = layer0._analyze(opt, x, f0)
        return chunk0["c"]

    stages = [("analyze", analysis), ("to_layer1", layer1.chunk_to_layer1),
              ("to_layer0", layer1.chunk_to_layer0),
              ("synthesize", lambda c: layer0._synthesize(sopt, c))]
    kernels.reset_launches()
    calls, (out, _) = capture_kernel_inputs(kernels, (VITERBI,),
                                            lambda: staged(torch, stages))
    launches = dict(kernels.LAUNCHES)
    phase("9 layer1 launches", all(launches[k] > 0 for k in
                                   PATH + (VITERBI,)), str(launches))
    phase("9 layer1 output", tuple(out.y.shape) == tuple(x.shape)
          and bool(torch.isfinite(out.y).all()),
          f"y {tuple(out.y.shape)} finite")
    snr = snr_rows(torch, x_ref, out.y_sin, conf.fs, conf.f0_floor)
    print(f"9 layer1: y_sin snr by row (dB): {[round(v, 4) for v in snr]}",
          flush=True)
    pin_clean = LAYER1_PINS_DB[max(LAYER1_PINS_DB)]
    check_snr("9 layer1", snr, LAYER1_PINS_DB, None)
    phase("9 layer1 every clean row", min(snr[B // 2:]) >= pin_clean
          - CLEAN_TOL_DB, f"min {min(snr[B // 2:]):.4f} dB (pin {pin_clean} "
          f"- {CLEAN_TOL_DB})")
    ms, peak = median_stages(torch, stages, 3)
    g = torch.Generator(device=x.device).manual_seed(0)
    score = torch.rand((B, chunk0["c"].nfrm, layer1.RD_GRID_SIZE),
                       generator=g, device=x.device)
    voiced = chunk0["c"].f0 > 0
    vit_ms = cuda_ms(torch, lambda: layer1._rd_viterbi(score, voiced, 10.0), 3)
    print(f"9 layer1: _rd_viterbi on [{B}, {score.shape[1]}, "
          f"{score.shape[2]}] scores {vit_ms:.2f} ms a call (median of 3; "
          f"two calls in each chunk_to_layer1, one viterbi_scan launch "
          f"each)", flush=True)
    del score
    check_rows("9 layer1", *rows_alone(torch, layer1_stages(mods, sopt),
                                       chunk0["c"]))
    l1_ms = ms["to_layer1"] + ms["to_layer0"] + ms["synthesize"]
    phase("9 layer1 step", True,
          f"{B} x {DURATION} s: " + ", ".join(f"{k} {v:.2f} ms"
                                              for k, v in ms.items())
          + f" (median of 3); layer-1 round trip {l1_ms:.2f} ms = "
          f"{B * DURATION / (l1_ms / 1e3):.1f} audio-sec/s; with the analysis "
          f"{B * DURATION / (sum(ms.values()) / 1e3):.1f} audio-sec/s; peak "
          f"{peak:.2f} GiB")
    return chunk0["c"], launches, calls[VITERBI][0]


def pbp_phase(torch, kernels, mods, opt, sopt, dev):
    """Phase 10: LF rows -> the library-default analysis -> chunk_to_layer1
    -> pbp_synthesize -> (launches, the layer-1 chunk)."""
    from libllsm2_tpu_torch.container import (chunk_from_numpy,
                                              chunk_to_numpy, index_batch)
    layer0, layer1, pbp = mods
    t0 = time.perf_counter()
    x, f0 = lf_fixtures(torch, dev)
    print(f"10 pbp fixtures: {BATCH} x {DURATION} s of synth_lf_speech in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    B = x.shape[0]
    conf = opt.conf
    chunk0 = {}

    def analysis(_):
        chunk0["c"] = layer0._analyze(opt, x, f0)
        return chunk0["c"]

    stages = [("analyze", analysis), ("to_layer1", layer1.chunk_to_layer1),
              ("pbp", lambda c: (c, pbp._pbp_synthesize(sopt, c)))]
    kernels.reset_launches()
    (l1, out), _ = staged(torch, stages)
    launches = dict(kernels.LAUNCHES)
    phase("10 pbp launches", launches["noise_mod_ola"] > 0
          and launches["fir_frames"] > 0 and launches["noise_bins"] > 0
          and launches[VITERBI] > 0, str(launches))
    phase("10 pbp output", tuple(out.y.shape) == tuple(x.shape)
          and bool(torch.isfinite(out.y).all()),
          f"y {tuple(out.y.shape)} finite")
    errs = []
    for b in range(B):
        med = float(torch.median(l1.rd[b][l1.f0[b] > 0]))
        errs.append(abs(med - LF_RD[b % len(LF_RD)]) / LF_RD[b % len(LF_RD)])
    worst = max(range(B), key=errs.__getitem__)
    phase("10 pbp rd", max(errs) <= RD_REL_TOL,
          f"median voiced rd within {max(errs) * 100:.2f}% of the truth "
          f"(worst row {worst}, Rd {LF_RD[worst % len(LF_RD)]}; "
          f"limit {RD_REL_TOL * 100:.0f}%)")
    for row, pin in RD_PINS.items():
        med = float(torch.median(l1.rd[row][l1.f0[row] > 0]))
        phase(f"10 pbp rd row {row}", abs(med - pin) <= RD_PIN_REL_TOL * pin,
              f"median voiced rd {med:.6f} (JAX {pin:.6f} +- "
              f"{RD_PIN_REL_TOL * 100:.0f}%)")
    # the card's Rd fit (scores, Viterbi, IRLS pass) against the CPU's on
    # one full-length row from the same layer-0 parameters
    t0 = time.perf_counter()
    row_cpu = chunk_from_numpy(chunk_to_numpy(index_batch(chunk0["c"],
                                                          slice(0, 1))),
                               conf, device="cpu")
    rd_cpu = layer1.chunk_to_layer1(row_cpu).rd[0]
    rel = torch.abs(l1.rd[0].cpu() - rd_cpu) / rd_cpu
    phase("10 pbp rd row 0 card vs cpu", float(rel.max()) <= RD_CPU_REL_TOL,
          f"{rd_cpu.shape[0]} frames: max relative difference "
          f"{float(rel.max()):.3e}, {int((rel > RD_CPU_REL_TOL).sum())} "
          f"frames over {RD_CPU_REL_TOL} (CPU fit "
          f"{time.perf_counter() - t0:.1f} s)")
    y_sin = layer0._synthesize(sopt, layer1.chunk_to_layer0(l1)).y_sin
    for row, pin in PBP_PINS_DB.items():
        snr = snr_db(torch, y_sin[row], out.y_sin[row], conf.fs, conf.f0_floor)
        phase(f"10 pbp snr row {row}", abs(snr - pin) <= NOISY_TOL_DB,
              f"PbP y_sin against the sinusoidal y_sin {snr:.4f} dB "
              f"(JAX {pin:.4f} +- {NOISY_TOL_DB})")
    del y_sin, out
    check_rows("10 pbp", *rows_alone(torch, [
        layer1_stages(mods, sopt)[0],
        ("pbp_synthesize", lambda c: outputs(pbp._pbp_synthesize(sopt, c)))],
        chunk0["c"]))
    chunk0.clear()
    ms, peak = median_stages(torch, stages, 3)
    phase("10 pbp step", True,
          f"{B} x {DURATION} s: " + ", ".join(f"{k} {v:.2f} ms"
                                              for k, v in ms.items())
          + f" (median of 3); PbP {B * DURATION / (ms['pbp'] / 1e3):.1f} "
          f"audio-sec/s; peak {peak:.2f} GiB")
    return launches, l1


def corpus_phase(torch, kernels, opt, sopt, rows, dev):
    """Phase 11, BASELINE config 5 from files on one card: CORPUS_FILES
    int16 WAVs cut from the bench rows (numpy x, f0) through
    run_corpus_files (CORPUS_BUCKETS, CORPUS_BATCH, want_audio=False),
    counters zeroed before -> (launches, the tracker's viterbi_scan call
    (args, kw) on a full batch of 8 s files).  Checks: every file yielded
    once, resume yields nothing, a batch from files equals run_corpus on
    the quantized signals bit for bit, tracked files alone equal their
    batch rows, the JAX pins of the first 16 files; then a warm run
    timed."""
    import math
    import os
    import tempfile

    import numpy as np

    from libllsm2_tpu_torch.ops import f0 as f0mod
    from libllsm2_tpu_torch.parallel import corpus
    from libllsm2_tpu_torch.utils import dataio, testsig
    phase("11 native loader", dataio.native_available(),
          f"native/llsm_loader.cpp built with g++ into {dataio._SO_PATH}")
    fs, nhop = opt.conf.fs, opt.conf.nhop
    xs, f0s = rows

    def run(paths, batch_size=CORPUS_BATCH, **kw):
        """run_corpus_files with each tracker call's output kept by path ->
        (the yielded dicts, {path: its F0 row on the card})."""
        out, tracked, calls = [], {}, []
        track = f0mod.track_batch

        def hook(*args, **kw_):
            calls.append(track(*args, **kw_))
            return calls[-1]

        f0mod.track_batch = hook
        try:
            for r in corpus.run_corpus_files(opt, sopt, paths, CORPUS_BUCKETS,
                                             batch_size, **kw):
                untracked = [p for p in r["paths"] if not sidecar[p]]
                if untracked:
                    tracked.update(zip(untracked, calls.pop()))
                out.append(r)
        finally:
            f0mod.track_batch = track
        return out, tracked

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        paths = testsig.write_test_corpus(
            d, CORPUS_FILES, lambda i: (xs[testsig.corpus_row(i)],
                                        f0s[testsig.corpus_row(i)]),
            fs=fs, nhop=nhop)
        sidecar = {p: os.path.exists(p[:-4] + ".f0.npy") for p in paths}
        audio_s = sum(dataio.wav_nsamples(p) for p in paths) / fs
        print(f"11 corpus: {len(paths)} int16 WAVs at {fs:g} Hz, "
              f"{audio_s:.1f} s of audio, {sum(sidecar.values())} with an F0 "
              f"sidecar, written in {time.perf_counter() - t0:.1f} s", flush=True)

        ckpt = {}
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, trk = run(paths, checkpoint=ckpt)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        phase("11 launches", all(launches[k] > 0 for k in PATH + (VITERBI,)),
              str(launches))
        got = [p for r in res for p in r["paths"]]
        phase("11 every file once", sorted(got) == sorted(paths),
              f"{len(got)} rows in {len(res)} batches of buckets "
              f"{sorted({r['bucket'] for r in res})}")
        snr = {p: float(s) for r in res for p, s in zip(r["paths"], r["snr"])}
        phase("11 snr finite", all(map(math.isfinite, snr.values())),
              f"{len(snr)} rows")
        again = list(corpus.run_corpus_files(opt, sopt, paths, CORPUS_BUCKETS,
                                             CORPUS_BATCH, checkpoint=ckpt))
        phase("11 resume", again == [], f"a second call with the checkpoint "
              f"({len(ckpt['done'])} batches done) yields {len(again)}")
        for kind, want in (("sidecar", True), ("tracked", False)):
            v = [s for p, s in snr.items() if sidecar[p] == want]
            print(f"11 snr of {kind} rows: mean {statistics.fmean(v):.4f} dB, "
                  f"min {min(v):.4f}, max {max(v):.4f} over {len(v)} files",
                  flush=True)

        # the JAX package's run_corpus_files on the first 16 files
        for i, (pin, runs) in CORPUS_PINS.items():
            p = paths[i]
            if runs is None:
                phase(f"11 jax pin file {i} (sidecar)",
                      abs(snr[p] - pin) <= CORPUS_SIDECAR_TOL_DB,
                      f"{snr[p]:.4f} dB (JAX {pin:.4f} +- "
                      f"{CORPUS_SIDECAR_TOL_DB})")
                continue
            jv = np.repeat(np.arange(len(runs)) % 2 == 1, runs)
            tv = (trk[p] > 0).cpu().numpy()
            agree = float(np.mean(jv == tv)) if len(jv) == len(tv) else 0.0
            flips = np.flatnonzero(jv != tv).tolist() if agree else []
            phase(f"11 jax pin file {i} (tracked)",
                  agree >= CORPUS_VOICING_MIN
                  and abs(snr[p] - pin) <= CORPUS_TRACKED_TOL_DB,
                  f"voicing agrees in {agree * 100:.2f}% of {len(tv)} frames "
                  f"(>= {CORPUS_VOICING_MIN * 100:.0f}%; differs at "
                  f"{flips}, the file ends at frame "
                  f"{dataio.wav_nsamples(p) // nhop}); {snr[p]:.4f} dB "
                  f"(JAX {pin:.4f} +- {CORPUS_TRACKED_TOL_DB})")

        # a batch from files against run_corpus on its quantized signals
        first = next(r for r in res if r["bucket"] == CORPUS_BUCKETS[1])
        b, P = first["bucket"], first["paths"]
        one, _ = run(P, want_audio=True)
        x16, ln, _ = dataio.load_wav_batch(P, b * nhop, dtype="int16")
        xq = x16.astype(np.float32) * np.float32(1.0 / 32767.0)
        ref = list(corpus.run_corpus(
            opt, sopt, [xq[j, :n] for j, n in enumerate(ln)],
            [np.load(p[:-4] + ".f0.npy") if sidecar[p] else
             trk[p].cpu().numpy() for p in P], CORPUS_BUCKETS, CORPUS_BATCH))
        n_side = sum(sidecar[p] for p in P)
        y_ref = ref[0]["y"][:len(P)].cpu().numpy()
        phase("11 files = run_corpus on the quantized signals",
              len(one) == len(ref) == 1 and one[0]["paths"] == P
              and ref[0]["indices"] == list(range(len(P)))
              and np.array_equal(one[0]["snr"], ref[0]["snr"])
              and np.array_equal(one[0]["snr"], first["snr"])
              and np.array_equal(one[0]["y"], y_ref)
              and np.array_equal(one[0]["nx"], ln),
              f"bucket {b}: {len(P)} rows ({n_side} with a sidecar, the "
              f"others with their tracked F0), SNR and y bit for bit")
        del ref, y_ref, one

        # tracked files alone (a batch of one) against their batch rows
        alone = [p for p in paths if not sidecar[p]][:CORPUS_ALONE]
        for p in alone:
            r1, t1 = run([p], batch_size=1)
            same_f0 = torch.equal(t1[p], trk[p])
            s1 = float(r1[0]["snr"][0])
            phase(f"11 tracked {os.path.basename(p)} alone = in its batch",
                  same_f0 and s1 == snr[p],
                  f"bucket {r1[0]['bucket']}: F0 ({t1[p].shape[0]} frames, "
                  f"{int((t1[p] > 0).sum())} voiced) equal: {same_f0}; SNR "
                  f"alone {s1!r} dB, in the batch {snr[p]!r}")

        # the warm run, timed: files to SNR on the host
        timings = []
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res2, _ = run(paths, timings=timings)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        snr2 = {p: float(s) for r in res2 for p, s in zip(r["paths"], r["snr"])}
        phase("11 warm run", snr2 == snr, f"the same {len(snr2)} SNRs bit for "
              "bit")
        for bkt in CORPUS_BUCKETS:
            t = [r for r in timings if r["bucket"] == bkt]
            # the run's first batch has nothing to hide behind
            asm = sum(r["assemble_ms"] for r in t if r is not timings[0])
            wait = sum(r["wait_ms"] for r in t if r is not timings[0])
            med = lambda k: statistics.median(r[k] for r in t)
            print(f"11 bucket {bkt} ({bkt * nhop / fs:g} s): {len(t)} batches, "
                  f"{sum(r['rows'] for r in t)} files; step {med('step_ms'):.2f}"
                  f" ms, tracker {med('track_ms'):.2f} ms, assemble "
                  f"{med('assemble_ms'):.2f} ms (median a batch); "
                  f"{max(0.0, 1.0 - wait / max(asm, 1e-9)) * 100:.1f}% of "
                  f"the assembly hidden behind the card (waited {wait:.1f} of "
                  f"{asm:.1f} ms, the run's first batch left out)",
                  flush=True)
        print(f"11 tracker: {sum(r['track_ms'] for r in timings):.1f} ms of "
              f"the {wall * 1e3:.1f} ms run", flush=True)

        # the tracker and its Viterbi alone on a full 8 s batch
        P = [p for r in res for p in r["paths"]
             if r["bucket"] == CORPUS_BUCKETS[-1]][:CORPUS_BATCH]
        b = CORPUS_BUCKETS[-1]
        x16, _, _ = dataio.load_wav_batch(P, b * nhop, dtype="int16")
        xq = torch.tensor(x16, device=dev).float() * corpus.PCM16_SCALE
        cfg = f0mod.F0Config(fs=fs, nhop=nhop, f0_floor=max(60.0,
                                                           opt.conf.f0_floor))
        g = torch.Generator(device=dev).manual_seed(0)
        logobs = torch.rand((len(P), b, cfg.nbins + 1), generator=g,
                            device=dev)
        lt = f0mod._tables(cfg, dev)["lt"]
        tr_ms = synced_ms(torch, lambda: f0mod.track_batch(cfg, xq), 3)
        vit_ms = synced_ms(torch, lambda: f0mod.viterbi(logobs, lt), 3)
        print(f"11 tracker on [{len(P)}, {b * nhop}]: {tr_ms:.2f} ms a batch, "
              f"of which the Viterbi (one viterbi_scan launch over {b} "
              f"frames) {vit_ms:.2f} ms (median of 3)", flush=True)
        # the tracker's own observations of this batch, for phase 11v
        calls, _ = capture_kernel_inputs(
            kernels, (VITERBI,), lambda: f0mod.track_batch(cfg, xq))
        del xq, logobs
        phase("11 corpus from files", True,
              f"{len(paths)} files, {audio_s:.1f} s of audio: warm run "
              f"{wall * 1e3:.1f} ms = {audio_s / wall:.1f} audio-sec/s from "
              f"files to SNR (the first, cold run {cold * 1e3:.1f} ms = "
              f"{audio_s / cold:.1f}); peak {peak:.2f} GiB")
    return launches, calls[VITERBI][0]


def sm_clock_mhz(torch):
    """-> (the SM clock in MHz, its source): the clock_rate that
    torch.cuda.get_device_properties reports (kHz), where this PyTorch has
    it, else nvidia-smi's clocks.max.sm."""
    khz = getattr(torch.cuda.get_device_properties(0), "clock_rate", None)
    if khz:
        return khz / 1e3, "torch.cuda.get_device_properties"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(smi.stdout.split()[0]), "nvidia-smi clocks.max.sm"


def viterbi_special_cases(torch, rd_obs, f0_obs):
    """Phase 11v's inputs that the captured calls lack: phase 9's Rd scores
    in eighths with 10% -inf entries (frames of one row all -inf among
    them) and an unvoiced stretch (frames 400-599 all zero, as _rd_viterbi
    masks them: every candidate of a frame tied before the penalty); the
    tracker's in eighths with 10% -inf entries (never the unvoiced state,
    so no renormalized frame is all -inf) and frames 400-599 each one
    constant (all tied); the tracker's 64 rows joined in pairs into 32
    rows of 3200 frames, whose backpointers go to device memory."""
    g = torch.Generator(device=rd_obs.device).manual_seed(11)
    eighths = lambda t: torch.round(t * 8.0) / 8.0
    rd = eighths(rd_obs)
    rd[torch.rand(rd.shape, generator=g, device=rd.device) < 0.1] = \
        -float("inf")
    rd[0, 1000:1003] = -float("inf")
    rd[:, 400:600] = 0.0
    tr = eighths(f0_obs)
    hole = torch.rand(tr.shape, generator=g, device=tr.device) < 0.1
    hole[..., -1] = False
    tr[hole] = -float("inf")
    tr[:, 400:600] = tr[:, 400:600, -1:]
    B, N, S = f0_obs.shape
    return rd, tr, f0_obs[:B // 2 * 2].reshape(B // 2, 2 * N, S)


def viterbi_phase(torch, kernels, rd_call, f0_call):
    """Phase 11v: viterbi_scan against its twin on the card, paths and last
    scores equal bit for bit, on phase 9's first captured Rd call ([128,
    1600, 64], no renormalization) and phase 11's tracker call ([64, 1600,
    97], renormalized), on both rounded to multiples of 1/8 (the tracker's
    transitions too: tied candidates), on row 0 of each alone, on rows
    0-1, on both with -inf entries and tied frames, and on the tracker's
    rows joined into 3200-frame rows (the backpointers in device memory:
    viterbi_special_cases) -> (cases, the full-batch records).  Each case's
    kernel and twin times are medians of 10, beside its bound and the
    kernel's cycles a step at the SM clock."""
    eighths = lambda t: torch.round(t * 8.0) / 8.0
    (rd_obs, rd_lt, rd_renorm), _ = rd_call
    (f0_obs, f0_lt, f0_renorm), _ = f0_call
    rd_inf, f0_inf, f0_long = viterbi_special_cases(torch, rd_obs, f0_obs)
    runs = [("9 rd", (rd_obs, rd_lt, rd_renorm)),
            ("11 tracker", (f0_obs, f0_lt, f0_renorm)),
            ("9 rd in eighths", (eighths(rd_obs), rd_lt, rd_renorm)),
            ("11 tracker in eighths", (eighths(f0_obs), eighths(f0_lt),
                                       f0_renorm)),
            ("9 rd row 0", (rd_obs[:1], rd_lt, rd_renorm)),
            ("11 tracker row 0", (f0_obs[:1], f0_lt, f0_renorm)),
            ("9 rd 2 rows", (rd_obs[:2], rd_lt, rd_renorm)),
            ("11 tracker 2 rows", (f0_obs[:2], f0_lt, f0_renorm)),
            ("9 rd with -inf and an unvoiced stretch",
             (rd_inf, rd_lt, rd_renorm)),
            ("11 tracker with -inf and tied frames",
             (f0_inf, eighths(f0_lt), f0_renorm)),
            ("11 tracker rows joined in pairs (backpointers in device "
             "memory)", (f0_long, f0_lt, f0_renorm))]
    mhz, clock_src = sm_clock_mhz(torch)
    cases, full = [], []
    for label, args in runs:
        B, N, S = args[0].shape
        geo = kernels._viterbi_geometry(N, S)
        case = check_kernel(torch, kernels, VITERBI, KERNELS[VITERBI][2],
                            args, {"scores": True}, label, prefix="11v")
        run = run_ms(torch, lambda: kernels.viterbi_scan(*args), 20)
        cycles = case["ms"] / max(N - 1, 1) * mhz * 1e3
        print(f"11v {label}: [{B}, {N}, {S}] kernel {case['ms']:.4f} ms "
              f"(run {run:.4f}) = {case['ms'] / case['bound_ms']:.1f}x its "
              f"{case['bound_ms']:.4f} ms bound ({case['bound_by']}; the "
              f"kernel's floor is a chain of {N - 1} dependent steps and "
              f"{N - 1} dependent backtrace loads, which the bound does "
              f"not count) = {cycles:.0f} cycles a step at {mhz:.0f} MHz "
              f"({clock_src}); P {geo[0]} lanes a state, C {geo[1]}, lt "
              f"mode {geo[3]}, backpointers in "
              f"{'shared' if geo[4] else 'device'} memory; twin "
              f"{case['plain_ms']:.4f} ms", flush=True)
        case["run_ms"] = run
        case["cycles_a_step"] = cycles
        cases.append(case)
        if label in ("9 rd", "11 tracker"):
            full.append({"phase": label.split()[0], "call": 0,
                         "shapes": case["shapes"], "ms": case["ms"],
                         "run_ms": run, "bound_ms": case["bound_ms"],
                         "bound_by": case["bound_by"], "library_ms": None,
                         "library_row_fraction": None, "host_ms": None,
                         "max_abs_err": case["max_abs_err"]})
    del rd_inf, f0_inf, f0_long
    torch.cuda.empty_cache()
    return cases, full


def edits_phase(torch, kernels, mods, l1, sopt):
    """Phase 12, BASELINE config 4: pitch_shift(2.0) -> time_stretch(1.5) ->
    synthesize on phase 10's layer-1 chunk, counters zeroed before ->
    launches; then the chain and each edit timed at the full batch."""
    import numpy as np

    layer0, edits = mods
    B, N = l1.f0.shape
    nhop = l1.conf.nhop
    chain = lambda: edits.time_stretch(edits.pitch_shift(l1, 2.0), 1.5)
    kernels.reset_launches()
    ed = chain()
    out = layer0.synthesize_batch(sopt, ed)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    phase("12 launches", all(launches[k] > 0 for k in
                             ("osc_bank", "noise_mod_ola", "noise_bins",
                              "sample_cycles")), str(launches))
    n = max(int(round(N * 1.5)), 2)
    phase("12 output", ed.nfrm == n and tuple(out.y.shape) == (B, n * nhop)
          and bool(torch.isfinite(out.y).all()),
          f"{N} -> {ed.nfrm} frames (expected {n}); y {tuple(out.y.shape)} "
          "finite")
    # numpy's median (the two middle values averaged), as the pins take it
    med = lambda f: float(np.median(f[f > 0].cpu().numpy()))
    ratio = [med(ed.f0[b]) / med(l1.f0[b]) for b in range(B)]
    worst = max(range(B), key=lambda b: abs(ratio[b] - 2.0))
    phase("12 f0 doubled", abs(ratio[worst] - 2.0) <= 2.0 * EDIT_DOUBLE_TOL,
          f"voiced median F0 / the chunk's: {min(ratio):.6f}-{max(ratio):.6f}"
          f" over {B} rows (2 +- {EDIT_DOUBLE_TOL * 100:g}%)")
    for row, pin in EDIT_PINS.items():
        f = med(ed.f0[row])
        rms = float(torch.sqrt(torch.mean(out.y_sin[row].double() ** 2)))
        db = 20.0 * math.log10(rms / pin["rms"])
        phase(f"12 jax pin row {row}", ed.nfrm == pin["nfrm"]
              and abs(f / pin["f0_median"] - 1.0) <= EDIT_F0_REL_TOL
              and abs(db) <= EDIT_RMS_TOL_DB,
              f"nfrm {ed.nfrm} (JAX {pin['nfrm']}); voiced median F0 "
              f"{f:.4f} Hz (JAX {pin['f0_median']:.4f} +- "
              f"{EDIT_F0_REL_TOL:g} relative); y_sin rms {db:+.4f} dB from "
              f"the JAX package's (+- {EDIT_RMS_TOL_DB})")
    del ed, out
    check_rows("12", *rows_alone(torch, edit_stages(mods, sopt), l1))
    stages = [("pitch_shift", lambda _: edits.pitch_shift(l1, 2.0)),
              ("time_stretch", lambda c: edits.time_stretch(c, 1.5)),
              ("synthesize", lambda c: layer0.synthesize_batch(sopt, c))]
    ms, peak = median_stages(torch, stages, 3)
    total = sum(ms.values())
    print(f"12 chain on {B} x {N * l1.conf.thop:g} s: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in ms.items()) + f" (median of 3); "
          f"{total:.2f} ms = {B * N * l1.conf.thop / (total / 1e3):.1f} "
          f"audio-sec/s of input; peak {peak:.2f} GiB", flush=True)
    other = edits.excerpt(l1, N // 16, N - N // 16)
    one = {"pitch_shift": lambda: edits.pitch_shift(l1, 2.0),
           "vibrato": lambda: edits.vibrato(l1),
           "tremolo": lambda: edits.tremolo(l1),
           "time_stretch": lambda: edits.time_stretch(l1, 1.5),
           "formant_shift": lambda: edits.formant_shift(l1, 1.2),
           "breathiness": lambda: edits.breathiness(l1, 6.0, rd_delta=0.3),
           "creak": lambda: edits.creak(l1, 0.5),
           "morph": lambda: edits.morph(l1, other, 0.5),
           "concat": lambda: edits.concat(l1, other, 8),
           "excerpt": lambda: edits.excerpt(l1, N // 16, N - N // 16)}
    times = []
    for name, fn in one.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, gib = peak_above(torch, fn)
        torch.cuda.synchronize()
        times.append(f"{name} {(time.perf_counter() - t0) * 1e3:.2f} ms "
                     f"{gib:.2f} GiB")
        del res
    del other
    phase("12 edits", True, f"each once on {B} x {N} frames (ms, peak above "
          "its start): " + ", ".join(times))
    return launches


def rows_report(torch, mods, opt, sopt, data, dev):
    """The rows form: the rows-alone checks of phases 9, 10 and 12 on
    their inputs, each printed and none failing the run."""
    layer0, layer1, pbp, edits = mods
    x, f0 = data[:2]
    check_rows("9 layer1", *rows_alone(torch, layer1_stages(mods, sopt),
                                       layer0._analyze(opt, x, f0)), False)
    x, f0 = lf_fixtures(torch, dev)
    l1 = layer1.chunk_to_layer1(layer0._analyze(opt, x, f0))
    del x, f0
    check_rows("10 pbp", *rows_alone(torch, [
        ("pbp_synthesize", lambda c: outputs(pbp._pbp_synthesize(sopt, c)))],
        l1), False)
    check_rows("12", *rows_alone(torch, edit_stages((layer0, edits), sopt),
                                 l1), False)


def codec_phase(torch, kernels, mods, l1, sopt):
    """Phase 13, the codec (cell codec-8bit) on phase 10's layer-1 chunk:
    encode -> fit_quantizer (8 bits, Rd by DPCM, the F0 slot's re-sync)
    -> coded_save -> coded_load -> decode -> synthesize_batch, counters
    zeroed before -> launches; then the 16-bit archive and the float
    vectors, the stages timed, the MCDs, rows alone, the JAX pins ->
    (launches, the float vectors of rows 0 and 1).  The archives go to a
    temporary directory, removed after."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        return codec_run(torch, kernels, mods, l1, sopt, tmp)


def codec_run(torch, kernels, mods, l1, sopt, tmp):
    import os

    import numpy as np

    layer0, layer1, coder, serialize, metrics = mods
    B, N = l1.f0.shape
    cc = coder.CoderConfig(conf=l1.conf)
    audio_s = B * N * l1.conf.thop
    path = lambda name: os.path.join(tmp, name)

    def quantize_save(v, bits=8, name="codec.npz", quant=None):
        q = quant or coder.fit_quantizer(
            v, bits=bits, dpcm=coder.default_dpcm_mask(cc),
            f0_slot=coder.f0_slot(cc))
        serialize.coded_save(path(name), cc, v, bits=bits, quant=q)
        return q

    def save(v):
        quantize_save(v)
        return v

    render = lambda v: layer0.synthesize_batch(sopt, coder.decode(cc, v))
    stages = [("encode", lambda _: coder.encode(cc, l1)),
              ("quantize + save", save),
              ("load + dequantize",
               lambda _: serialize.coded_load(path("codec.npz"))[1]),
              ("decode", lambda v: coder.decode(cc, v)),
              ("synthesize", lambda c: layer0.synthesize_batch(sopt, c))]
    kernels.reset_launches()
    out, _ = staged(torch, stages)
    launches = dict(kernels.LAUNCHES)
    phase("13 codec launches", all(launches[k] > 0 for k in CODEC_KERNELS),
          str(launches))
    phase("13 codec output", tuple(out.y.shape) == (B, N * l1.conf.nhop)
          and bool(torch.isfinite(out.y).all()),
          f"y {tuple(out.y.shape)} finite")
    kbit = os.path.getsize(path("codec.npz")) * 8 / 1e3 / audio_s
    v = coder.encode(cc, l1)
    q8 = quantize_save(v)
    quantize_save(v, 16, "codec16.npz")
    v16 = serialize.coded_load(path("codec16.npz"))[1]
    kbit16 = os.path.getsize(path("codec16.npz")) * 8 / 1e3 / audio_s
    ys = {"float": render(v).y_sin.cpu().numpy(),
          "8-bit": out.y_sin.cpu().numpy(),
          "16-bit": render(v16).y_sin.cpu().numpy()}
    del out
    mcd = {k: [metrics.mel_cepstral_distortion_db(ys["float"][b], ys[k][b],
                                                  fs=cc.conf.fs)
               for b in range(B)] for k in ("8-bit", "16-bit")}
    print(f"13 codec: archive {kbit:.3f} kbit/s of audio at 8 bits "
          f"({kbit16:.3f} at 16; float32 vectors "
          f"{cc.dims * 32 / l1.conf.thop / 1e3:.3f}); MCD against the float "
          "decode, median over rows (min-max): " + ", ".join(
              f"{k} {statistics.median(m):.4f} dB ({min(m):.4f}-"
              f"{max(m):.4f})" for k, m in mcd.items()), flush=True)
    # decode_frames is the layer-1 decode's harmonics, unpropagated
    vq = serialize.coded_load(path("codec.npz"))[1]
    a = coder.decode_frames(cc, vq)
    b = layer1.chunk_to_layer0(coder.decode_layer1(cc, vq))
    phase("13 decode_frames = chunk_to_layer0(decode_layer1)",
          all(torch.equal(getattr(a, f), getattr(b, f))
              for f in ("f0", "ampl", "phse", "hm_mask", "rd", "vtmagn")),
          f"{B} x {N} frames bit for bit")
    rng = np.random.default_rng(0)
    finite = []
    for scale in (1.0, 1e3, 1e6):
        r = (scale * rng.standard_normal((4, 400, cc.dims))).astype(np.float32)
        finite.append(bool(torch.isfinite(render(r).y).all()))
    phase("13 random vectors decode to finite audio", all(finite),
          f"4 x 400 frames of N(0, s^2) vectors, s = 1, 1e3, 1e6: {finite}")

    # rows alone, the batch's prefitted quantizer: vectors, codes, decode
    def archive(v):
        name = f"rows{v.shape[0]}.npz"
        quantize_save(v, name=name, quant=q8)
        codes = np.load(path(name))["codes"]
        vq = serialize.coded_load(path(name))[1]
        return vq, {"codes": torch.from_numpy(codes.astype(np.int32)),
                    "vectors": torch.from_numpy(vq)}

    check_rows("13 codec", *rows_alone(torch, [
        ("encode", lambda c: (lambda v: (v, {"vectors": v}))(
            coder.encode(cc, c))),
        ("quantize + save + load", archive),
        ("decode", lambda v: fields(coder.decode(cc, v), ("f0", "ampl",
                                                          "phse", "rd"))),
        ("synthesize", lambda c: outputs(layer0.synthesize_batch(sopt, c)))],
        l1))

    # the JAX package's coder on rows 0 and 1 (its archive: codes, the
    # quantizer it fitted on them, the F0 side array): the card's vectors
    # coded with that quantizer, and with one fitted on them
    jz = np.load(CODER_PINS)
    _, jv = serialize.coded_load(CODER_PINS)
    jq = coder.Quantizer(lo=jz["lo"], hi=jz["hi"], bits=8, dpcm=jz["dpcm"],
                         dlo=jz["dlo"], dhi=jz["dhi"], f0_slot=coder.f0_slot(cc))
    v01 = v[:2]
    agree = {}
    for label, quant in (("the JAX quantizer", jq), ("its own", None)):
        q01 = quantize_save(v01, name="rows01.npz", quant=quant)
        codes = np.load(path("rows01.npz"))["codes"]
        vq01 = serialize.coded_load(path("rows01.npz"))[1]
        agree[label] = (float(np.mean(codes == jz["codes"])),
                        np.abs(vq01 - jv) / q01.step,
                        {name: round(float(np.mean(
                            codes[..., o:o + n] == jz["codes"][..., o:o + n]))
                                     * 100, 3)
                         for name, o, n in cc.layout()})
    # a step's codes differ by one: 1e-3 of slack for the float rounding
    within = {k: float(np.mean(a[1] <= 1.001)) for k, a in agree.items()}
    same = agree["the JAX quantizer"][0]
    phase("13 codec jax codes rows 0/1", same >= CODER_CODES_MIN
          and within["the JAX quantizer"] >= CODER_STEP_SHARE_MIN,
          f"codes of {jz['codes'].size} slots equal to the JAX package's; "
          "dequantized vectors within one quantizer step of its; their "
          "largest distance in steps; % equal by field: " + "; ".join(
              f"with {k}: {a * 100:.3f}%, {within[k] * 100:.3f}%, "
              f"{float(b.max()):.4f}, {c}" for k, (a, b, c) in agree.items())
          + f" (with the JAX quantizer >= {CODER_CODES_MIN * 100:g}% and >= "
          f"{CODER_STEP_SHARE_MIN * 100:g}%)")
    y01 = render(v01).y_sin.cpu().numpy()
    y8 = render(vq01).y_sin.cpu().numpy()      # its own quantizer, as JAX
    for row, pin in CODER_PINS_ROWS.items():
        rms = float(np.sqrt(np.mean(y01[row].astype(np.float64) ** 2)))
        db = 20.0 * math.log10(rms / pin["rms"])
        m8 = metrics.mel_cepstral_distortion_db(y01[row], y8[row],
                                                fs=cc.conf.fs)
        phase(f"13 codec jax pin row {row}", abs(db) <= CODER_RMS_TOL_DB
              and abs(m8 - pin["mcd8"]) <= CODER_MCD_TOL_DB,
              f"float decode y_sin rms {db:+.4f} dB from the JAX package's "
              f"(+- {CODER_RMS_TOL_DB}); 8-bit MCD {m8:.4f} dB (JAX "
              f"{pin['mcd8']:.4f} +- {CODER_MCD_TOL_DB})")
    del ys, y01, y8
    torch.cuda.reset_peak_memory_stats()
    ms, peak = median_stages(torch, stages, 3)
    total = sum(ms.values())
    phase("13 codec step", True,
          f"{B} x {N * l1.conf.thop:g} s: " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in ms.items())
          + f" (median of 3); {total:.2f} ms = {audio_s / (total / 1e3):.1f}"
          f" audio-sec/s; peak {peak:.2f} GiB")
    return launches, v01


def nasal_fixtures(torch, dev):
    """Phase 14's rows: synth_nasal_utterance, zero (900, 60) Hz, f0_base
    NASAL_F0[i % 3], seed i -> (x, f0)."""
    import numpy as np

    from libllsm2_tpu_torch.utils import testsig
    rows = [testsig.synth_nasal_utterance(
        duration=DURATION, seed=i, zero=(900.0, 60.0),
        f0_base=NASAL_F0[i % len(NASAL_F0)]) for i in range(BATCH)]
    return tuple(torch.tensor(np.stack([r[j] for r in rows]),
                              dtype=torch.float32, device=dev)
                 for j in range(2))


def nasal_phase(torch, kernels, mods, opt, dev):
    """Phase 14, the section-model Rd fit (cell nasal-sections): nasal rows
    -> the library-default analysis -> chunk_to_layer1 with and without
    NASAL_SECTIONS, counters zeroed before -> launches."""
    import numpy as np

    layer0, layer1 = mods
    t0 = time.perf_counter()
    x, f0 = nasal_fixtures(torch, dev)
    print(f"14 nasal fixtures: {BATCH} x {DURATION} s of "
          f"synth_nasal_utterance in {time.perf_counter() - t0:.1f} s",
          flush=True)
    kernels.reset_launches()
    ch = layer0._analyze(opt, x, f0)
    l1 = layer1.chunk_to_layer1(ch, None, NASAL_SECTIONS)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    phase("14 nasal launches", all(launches[k] > 0 for k in
                                   ANALYSIS + (VITERBI,)), str(launches))
    l1_none = layer1.chunk_to_layer1(ch)
    voiced = (ch.f0 > 0).cpu().numpy()
    med = lambda c: [float(np.median(c.rd[b].cpu().numpy()[voiced[b]]))
                     for b in range(BATCH)]
    rd, rd_none = med(l1), med(l1_none)
    phase("14 nasal output", all(map(math.isfinite, rd)), f"rd {tuple(l1.rd.shape)}")
    by = {f: [b for b in range(BATCH) if NASAL_F0[b % len(NASAL_F0)] == f]
          for f in NASAL_F0}
    print("14 nasal: median voiced rd by f0_base, the median over its rows "
          "(min-max), with sections / without: " + "; ".join(
              f"{f:g} Hz {statistics.median(rd[b] for b in rows):.4f} "
              f"({min(rd[b] for b in rows):.4f}-{max(rd[b] for b in rows):.4f})"
              f" / {statistics.median(rd_none[b] for b in rows):.4f} "
              f"({min(rd_none[b] for b in rows):.4f}-"
              f"{max(rd_none[b] for b in rows):.4f})"
              for f, rows in by.items()), flush=True)
    for f, (lo, hi) in NASAL_FLOORS.items():
        worst = [rd[b] for b in by[f]]
        phase(f"14 nasal floors at {f:g} Hz",
              all(lo < r < hi for r in worst),
              f"every row's median voiced rd with sections in "
              f"{min(worst):.4f}-{max(worst):.4f} (test_nasal: ({lo}, {hi}))")
    for row, pin in NASAL_PINS.items():
        for key, got in (("sections", rd[row]), ("none", rd_none[row])):
            phase(f"14 nasal jax pin row {row} {key}",
                  abs(got - pin[key]) <= RD_PIN_REL_TOL * pin[key],
                  f"median voiced rd {got:.6f} (JAX {pin[key]:.6f} +- "
                  f"{RD_PIN_REL_TOL * 100:g}%)")
    del l1, l1_none
    check_rows("14 nasal", *rows_alone(torch, [
        ("chunk_to_layer1 sections",
         lambda c: fields(layer1.chunk_to_layer1(c, None, NASAL_SECTIONS),
                          ("rd", "vtmagn", "vsphse")))], ch))
    ms, peak = median_stages(torch, [
        ("to_layer1 sections",
         lambda _: layer1.chunk_to_layer1(ch, None, NASAL_SECTIONS)),
        ("to_layer1", lambda _: layer1.chunk_to_layer1(ch))], 3)
    phase("14 nasal step", True,
          f"{BATCH} x {DURATION} s: " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in ms.items())
          + f" (median of 3); peak {peak:.2f} GiB")
    return launches


def phase5_breakdown(torch, mods, opt, sopt, data):
    """Phase 5's two harmonic_analysis calls (analysis_calls) and its two
    harmonic renders (render_calls), then its analysis and synthesis apart:
    time (median of 3) and the peak memory each takes above its inputs,
    which says which half sets the step's peak, and each analysis and
    synthesis stage's synchronized time and peak (stage_times) -> (the
    analysis-call records, the render-call records)."""
    harmonics, layer0, corpus, kernels = mods
    x, f0, x_ref, nxv = data
    step = lambda: corpus.batched_pipeline(opt, sopt, x, f0, nxv, x_ref)
    calls = analysis_calls(torch, harmonics, step)
    renders = render_calls(torch, harmonics, kernels, step)
    stages = [("analyze", lambda _: layer0._analyze(opt, x, f0)),
              ("synthesize", lambda c: layer0._synthesize(sopt, c))]
    ms, _ = median_stages(torch, stages, 3)
    chunk, peak_a = peak_above(torch, lambda: layer0._analyze(opt, x, f0))
    peak_s = peak_above(torch, lambda: layer0._synthesize(sopt, chunk))[1]
    print(f"5 stages: analyze {ms['analyze']:.2f} ms, peak {peak_a:.3f} GiB "
          f"above its inputs; synthesize {ms['synthesize']:.2f} ms, peak "
          f"{peak_s:.3f} GiB above the chunk (median of 3)", flush=True)
    # the analysis's own stages (siblings inside _analyze) and the
    # synthesis's: each call's time, synchronized before and after (summed
    # over a stage's calls; median of 3), and its peak above the memory
    # allocated when it starts (a call inside another resets the outer
    # call's peak count)
    ms, peaks = stage_times(torch, analysis_hooks(harmonics, layer0, kernels),
                            lambda: layer0._analyze(opt, x, f0))
    print("5 analysis stages, ms (synchronized, median of 3) and peak GiB "
          "above each call's start: " + ", ".join(
              f"{k} {ms[k]:.2f} ms {peaks[k]:.3f} GiB" for k in peaks)
          + f"; the analysis {ms['total']:.2f} ms, of which "
          f"{ms['total'] - sum(ms[k] for k in peaks):.2f} ms outside them",
          flush=True)
    # synthesis: the cycle track, the harmonic render and _synth_noise,
    # split into its kernel (noise_mod_ola) and the shaping before it (on
    # a package that builds the band segments apart, _band_segments too)
    hooks = [(harmonics, "sample_cycles"), render_hook(harmonics, kernels),
             (layer0, "_synth_noise"), (kernels, "noise_mod_ola")]
    if hasattr(layer0, "_band_segments"):
        hooks.append((layer0, "_band_segments"))
    ms, peaks = stage_times(torch, hooks,
                            lambda: layer0._synthesize(sopt, chunk))
    inner = [k for k in ("noise_mod_ola", "_band_segments") if k in ms]
    top = [k for k in ms if k not in inner and k != "total"]
    print("5 synthesis stages, ms (synchronized, median of 3) and peak GiB "
          "above each call's start: " + ", ".join(
              f"{k} {ms[k]:.2f} ms {peaks[k]:.3f} GiB" for k in peaks)
          + f"; _synth_noise's shaping (outside "
          f"{' and '.join(inner)}) {ms['_synth_noise'] - sum(ms[k] for k in inner):.2f}"
          f" ms; the synthesis {ms['total']:.2f} ms, of which "
          f"{ms['total'] - sum(ms[k] for k in top):.2f} ms outside them",
          flush=True)
    del chunk
    return calls, renders


def breakdown_kernels(torch, mods, opt, sopt, data):
    """The breakdown form's kernel times: a phase-5 step's sample_cycles
    calls, and env_render on that analysis chunk's envelopes (phase 9's
    shapes), each at full batch beside its bound (full_batch)."""
    harmonics, layer0, corpus, kernels = mods
    x, f0, x_ref, nxv = data
    calls, _ = capture_kernel_inputs(
        kernels, ("sample_cycles",),
        lambda: corpus.batched_pipeline(opt, sopt, x, f0, nxv, x_ref))
    chunk = layer0._analyze(opt, x, f0)
    nhop = opt.conf.nhop
    cyc = harmonics.sample_cycles(chunk.f0, nhop, opt.conf.fs,
                                  chunk.nfrm * nhop)
    env, _ = capture_kernel_inputs(
        kernels, ("env_render",),
        lambda: layer0._render_envelopes(chunk, cyc, nhop, use_pallas=True))
    calls.update(env)
    del chunk, cyc
    full_batch(torch, kernels, calls, "breakdown")


def stage_times(torch, hooks, run, reps=3):
    """run() reps times with each hooked (module, name) function timed
    (synchronized before and after, summed over its calls) and its peak
    above its start recorded -> ({name: median ms, "total": run's median
    ms}, {name: peak GiB})."""
    runs, peaks = [], {}

    def tracked(name, fn):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, gib = peak_above(torch, lambda: fn(*args, **kw))
            runs[-1][name] = runs[-1].get(name, 0.0) \
                + (time.perf_counter() - t0) * 1e3
            peaks[name] = max(peaks.get(name, 0.0), gib)
            return out
        return wrapped

    originals = [(mod, name, getattr(mod, name)) for mod, name in hooks]
    for mod, name, fn in originals:
        setattr(mod, name, tracked(name, fn))
    try:
        for _ in range(reps):
            runs.append({})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            runs[-1]["total"] = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    return ({k: statistics.median(r.get(k, 0.0) for r in runs)
             for k in runs[0]}, peaks)


def batch_rows(torch, mods, opt, sopt, data, snr_whole, rows=BATCH_ROWS,
               label="5"):
    """Phase 5 (and 20 with its options and rows): rows of the bench batch,
    each alone (a batch of one) and in the whole batch: every field of
    their analysis chunk, their y, y_sin and y_nos, and every
    kernels.sample_cycles call's input and output rows compared bit for
    bit; prints both runs' SNRs of those rows (the whole batch's from the
    counted run, snr_whole)."""
    from libllsm2_tpu_torch.container import LAYER0_FIELDS
    kernels, layer0, corpus = mods
    dev = data[0].device

    def record(d, pick):
        log, fns = [], (kernels.sample_cycles, layer0._analyze,
                        layer0._synthesize)
        got = {}

        def rec(f0, *a, **kw):
            out = fns[0](f0, *a, **kw)
            log.append((f0[pick].clone(), out[pick].clone()))
            return out

        def analyze(*a, **kw):
            chunk = fns[1](*a, **kw)
            got.update({k: getattr(chunk, k)[pick].clone()
                        for k in LAYER0_FIELDS})
            return chunk

        def synthesize(*a, **kw):
            out = fns[2](*a, **kw)
            got.update({k: getattr(out, k)[pick].clone()
                        for k in ("y", "y_sin", "y_nos")})
            return out
        kernels.sample_cycles = rec
        layer0._analyze, layer0._synthesize = analyze, synthesize
        try:
            x, f0, x_ref, nxv = d
            _, snr, _ = corpus.batched_pipeline(opt, sopt, x, f0, nxv, x_ref)
        finally:
            kernels.sample_cycles = fns[0]
            layer0._analyze, layer0._synthesize = fns[1:]
        torch.cuda.synchronize()
        return log, got, [round(float(v), 4) for v in snr[pick]]

    whole, got_whole, _ = record(data, torch.tensor(rows, device=dev))
    same, fields, snr_alone = [], {k: True for k in got_whole}, []
    for i, r in enumerate(rows):   # each row alone: a batch of one
        alone, got_alone, snr = record(tuple(v[r:r + 1] for v in data),
                                       torch.zeros(1, dtype=torch.long,
                                                   device=dev))
        snr_alone += snr
        same += [(torch.equal(a[0][0], w[0][i]), torch.equal(a[1][0], w[1][i]))
                 for a, w in zip(alone, whole)]
        for k in fields:
            fields[k] &= torch.equal(got_alone[k][0], got_whole[k][i])
    # the kernel on the bench's F0 tracks: each row alone against its row
    # of the whole batch's call
    nhop, fs, nx = opt.conf.nhop, opt.conf.fs, data[0].shape[-1]
    trk = kernels.sample_cycles(data[1], nhop, fs, nx)
    direct = all(torch.equal(kernels.sample_cycles(data[1][r:r + 1], nhop,
                                                   fs, nx)[0], trk[r])
                 for r in rows)
    # the refine (one launch of refine_f0.cu, no row groups) likewise
    from libllsm2_tpu_torch.ops import harmonics
    conf = opt.conf
    rkw = dict(nhop=nhop, fs=fs, halfwin_max=conf.halfwin_max,
               rel_winsize=conf.rel_winsize, f0_ceil=conf.f0_ceil)
    ref_b = harmonics.refine_f0(data[0], data[1], **rkw)
    refine = all(torch.equal(harmonics.refine_f0(
        data[0][r:r + 1], data[1][r:r + 1], **rkw)[0], ref_b[r])
        for r in rows)
    phase(f"{label} rows alone = in the batch",
          len(same) == len(rows) * len(whole) > 0 and direct
          and refine and all(o for i, o in same if i) and len(fields) == 11
          and all(fields.values()),
          f"rows {list(rows)}: every chunk field and output bit for "
          f"bit: {fields}; {len(same)} sample_cycles calls of the "
          f"pipeline, (f0 rows equal, tracks equal): {same}; "
          f"the kernel on the bench F0 rows alone = in the batch: {direct}; "
          f"refine_f0 on the bench rows alone = in the batch: {refine}; "
          f"SNR alone {snr_alone} dB, in the {BATCH}-row batch "
          f"{[round(snr_whole[r], 4) for r in rows]} dB")


def refine_phase(torch, kernels, harmonics, opt, data, rec, full):
    """Phase 5, refine_f0_dec beyond the pipeline's calls: row 0 alone (a
    batch of one, 1600 frames) and its frames REFINE_BLOCK (a 160-frame
    block, as RTAnalyzer's) held to the twin (check_kernel, cases added to
    rec); then the pass split at full batch on the bench rows: refine_f0.cu
    built four times by _build.variants (LLSM_SKIP_PASS_A: the decimation
    into shared memory compiled out, _B: the probes; the variants of
    scripts/port_kernel_passes.py), a launch's share of a run of 20 each;
    one line with the full-batch (full: phase 5's records) and 2-row
    times, the bound and the ratio."""
    from libllsm2_tpu_torch.ops import _build
    name = "refine_f0_dec"
    conf = opt.conf
    x, f0 = data[0], data[1]
    D, taps, g, pass_hz = harmonics.refine_decimation(
        conf.nhop, x.shape[-1], conf.fs, conf.f0_ceil)
    kw = dict(D=D, g=g, nhop=conf.nhop, fs=conf.fs,
              halfwin_max=conf.halfwin_max, rel_winsize=conf.rel_winsize,
              window="hanning", iters=2, max_rel_dev=0.05, pass_hz=pass_hz)
    a, b = REFINE_BLOCK
    for label, xa, fa in (("B = 1", x[:1], f0[:1]),
                          (f"{b - a}-frame block", x[:1, a * conf.nhop:
                                                         b * conf.nhop],
                           f0[:1, a:b])):
        rec["cases"].append(check_kernel(
            torch, kernels, name, KERNELS[name][2],
            (xa.contiguous(), fa.contiguous(), taps), kw, label, prefix="5"))
    rec["max_abs_err"] = max(c["max_abs_err"] for c in rec["cases"])
    what = {(0, 0): "nothing", (0, 1): "the probes",
            (1, 0): "the decimation", (1, 1): "both"}
    t0 = time.perf_counter()
    libs = _build.variants([("refine_f0", {"LLSM_SKIP_PASS_A": sa,
                                           "LLSM_SKIP_PASS_B": sb})
                            for sa, sb in what])
    built = time.perf_counter() - t0
    out = torch.empty_like(f0)
    args = kernels._refine_launch_args(x, f0, taps, out, **kw)
    split, rcs = {}, []
    for (sa, sb), lib in zip(what, libs):
        fn = lib.llsm_refine_f0_dec
        rcs.append(fn(*args))
        split[what[sa, sb]] = run_ms(torch, lambda: fn(*args), 20)
    f = full[name][0]
    rec["passes"] = split
    phase(f"5 {name}", not any(rcs) and f["bound_ms"] > 0,
          f"full batch {f['ms']:.4f} ms (run {f['run_ms']:.4f}), 2 rows "
          f"{rec['ms']:.4f} ms, bound {f['bound_ms']:.4f} ms "
          f"({f['bound_by']}): {f['ms'] / f['bound_ms']:.2f}x its bound "
          f"(run {f['run_ms'] / f['bound_ms']:.2f}x); passes at full batch "
          f"(refine_f0.cu's LLSM_SKIP_PASS variants, built in "
          f"{built:.1f} s; a launch in a run of 20), skipping "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
          + f"; launch codes {rcs}")


def refine_full_kw(conf):
    """kernels.refine_f0_full's keyword arguments for conf's refine (the
    library's: hanning, 2 iterations, 5%)."""
    return dict(nhop=conf.nhop, fs=conf.fs, halfwin_max=conf.halfwin_max,
                rel_winsize=conf.rel_winsize, window="hanning", iters=2,
                max_rel_dev=0.05)


def refine_k1_operands(torch, kernels, conf, data):
    """harmonic_project's arguments (dc, xw, 1, lo, hi) of the full-rate
    refine's first probe (centres n nhop - delta, the input F0) on data's
    rows, framed as refine_f0_full_ref frames them: [B N, 2 H + 1]."""
    x, f0 = data[0], data[1]
    H = conf.halfwin_max
    dm = kernels._refine_full_dims(conf.nhop, conf.fs, H)
    f0s = torch.where(f0 > 0, f0, torch.full_like(f0, 100.0))
    hw = torch.clamp(conf.rel_winsize * conf.fs / (2.0 * f0s), 2.0, float(H))
    cts = torch.arange(f0.shape[1], device=x.device) * conf.nhop - dm["delta"]
    dc, xw, lo, hi = kernels._refine_full_frames(
        kernels._refine_full_pad(x, H), cts, f0s, hw, H=H, fs=conf.fs,
        window="hanning")
    return dc, xw, 1, lo, hi


def refine_full_phase(torch, kernels, harmonics, opt, data, rec, full):
    """Phase 7, refine_f0_full beyond the pipeline's call: row 0 alone (a
    batch of one, 1600 frames) and rows 0 and 1 end to end as one
    3200-frame row held to the twin (check_kernel, cases added to rec);
    refine_f0 on rows BATCH_ROWS alone equal to their rows of the batch
    bit for bit; then the pass split at full batch (refine_f0.cu built
    four times by _build.variants, as in refine_phase: LLSM_SKIP_PASS_A
    compiles the copy into shared memory out, _B the probes), a launch's
    share of a run of 20 each; one line with the full-batch (full: phase
    7's records) and 2-row times, the bound and the ratio."""
    from libllsm2_tpu_torch.ops import _build
    name = "refine_f0_full"
    conf = opt.conf
    x, f0 = data[0], data[1]
    kw = refine_full_kw(conf)
    for label, xa, fa in (("B = 1", x[:1], f0[:1]),
                          ("3200-frame row", x[:2].reshape(1, -1),
                           f0[:2].reshape(1, -1))):
        rec["cases"].append(check_kernel(
            torch, kernels, name, KERNELS[name][2],
            (xa.contiguous(), fa.contiguous()), kw, label, prefix="7"))
    rec["max_abs_err"] = max(c["max_abs_err"] for c in rec["cases"])
    rkw = dict(nhop=conf.nhop, fs=conf.fs, halfwin_max=conf.halfwin_max,
               rel_winsize=conf.rel_winsize, f0_ceil=conf.f0_ceil)
    whole = harmonics.refine_f0(x, f0, **rkw)
    alone = [torch.equal(harmonics.refine_f0(x[r:r + 1], f0[r:r + 1],
                                             **rkw)[0], whole[r])
             for r in BATCH_ROWS]
    phase("7 refine_f0 rows alone = in the batch", all(alone),
          f"rows {list(BATCH_ROWS)}: {alone}")
    what = {(0, 0): "nothing", (0, 1): "the probes",
            (1, 0): "the copy into shared memory", (1, 1): "both"}
    t0 = time.perf_counter()
    libs = _build.variants([("refine_f0", {"LLSM_SKIP_PASS_A": sa,
                                           "LLSM_SKIP_PASS_B": sb})
                            for sa, sb in what])
    built = time.perf_counter() - t0
    out = torch.empty_like(f0)
    args = kernels._refine_full_launch_args(x, f0, out, **kw)
    split, rcs = {}, []
    for (sa, sb), lib in zip(what, libs):
        fn = lib.llsm_refine_f0_full
        rcs.append(fn(*args))
        split[what[sa, sb]] = run_ms(torch, lambda: fn(*args), 20)
    f = full[name][0]
    rec["passes"] = split
    phase(f"7 {name}", not any(rcs) and f["bound_ms"] > 0,
          f"full batch {f['ms']:.4f} ms (run {f['run_ms']:.4f}), 2 rows "
          f"{rec['ms']:.4f} ms, bound {f['bound_ms']:.4f} ms "
          f"({f['bound_by']}): {f['ms'] / f['bound_ms']:.2f}x its bound "
          f"(run {f['run_ms'] / f['bound_ms']:.2f}x); passes at full batch "
          f"(refine_f0.cu's LLSM_SKIP_PASS variants, {built:.1f} s to "
          f"load or build; a launch in a run of 20), skipping "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
          + f"; launch codes {rcs}")


def analysis_hooks(harmonics, layer0, kernels):
    """(module, name) of each analysis stage stage_times reads."""
    return [(harmonics, "refine_f0"), (harmonics, "sample_cycles"),
            (harmonics, "harmonic_analysis"),
            (layer0, "_deconv_correction"), (layer0, "_track_denoise"),
            render_hook(harmonics, kernels), (layer0, "_band_envelopes"),
            (layer0, "_warped_psd")]


def phase7_breakdown(torch, mods, opt, data):
    """Phase 7's analysis on its rows, stage by stage (stage_times: each
    stage's synchronized time, median of 3, and its peak above its
    start), the refine's own line first, and the analysis's peak above
    its inputs."""
    harmonics, layer0, _, kernels = mods
    x, f0 = data[0], data[1]
    run = lambda: layer0._analyze(opt, x, f0)
    ms, peaks = stage_times(torch, analysis_hooks(harmonics, layer0,
                                                  kernels), run)
    peak = peak_above(torch, run)[1]
    print(f"7 refine: refine_f0 {ms['refine_f0']:.2f} ms (synchronized, "
          f"median of 3), peak {peaks['refine_f0']:.3f} GiB above its "
          f"start; x {tuple(x.shape)} at {opt.conf.fs} Hz, hop "
          f"{opt.conf.nhop}", flush=True)
    print("7 analysis stages, ms (synchronized, median of 3) and peak GiB "
          "above each call's start: " + ", ".join(
              f"{k} {ms[k]:.2f} ms {peaks[k]:.3f} GiB" for k in peaks)
          + f"; the analysis {ms['total']:.2f} ms, peak {peak:.3f} GiB "
          f"above its inputs", flush=True)


def capture_kernel_inputs(kernels, names, run):
    """Run `run()` with the functions `names` of module `kernels` recording
    the arguments of each call -> ({name: [(args, kw), ...]}, run's
    result)."""
    calls = {name: [] for name in names}
    originals = {name: getattr(kernels, name) for name in names}

    def hook(name):
        def wrapped(*args, **kw):
            calls[name].append((args, kw))
            return originals[name](*args, **kw)
        return wrapped

    for name in names:
        setattr(kernels, name, hook(name))
    try:
        result = run()
    finally:
        for name, fn in originals.items():
            setattr(kernels, name, fn)
    return calls, result


def stream_feed(torch, rta, x, f0, block_ms):
    """Feed one stream to an RTAnalyzer in 997-sample / 13-frame pieces
    (tests/test_rtanalyze.py's misaligned feed), then flush -> the streamed
    chunk.  Appends each feed's synchronized ms that completed a block to
    block_ms."""
    from libllsm2_tpu_torch.runtime.rtanalyze import concat_frames
    outs = []
    for k in range(max(len(x) // 997, len(f0) // 13) + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = rta.feed(x[997 * k:997 * (k + 1)], f0[13 * k:13 * (k + 1)])
        torch.cuda.synchronize()
        if got is not None:
            block_ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(got)
    tail = rta.flush()
    return concat_frames(outs + ([tail] if tail is not None else []))


def ampl_snr(ref, got):
    """tests/test_rtanalyze.py's SNR of two ampl arrays (numpy), dB."""
    import numpy as np
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(10.0 * np.log10(np.sum(ref ** 2)
                                 / max(np.sum((ref - got) ** 2), 1e-30)))


def stream_floors(st, off):
    """tests/test_rtanalyze.py::test_stream_equals_offline's measures of a
    streamed chunk against the offline one (numpy field dicts) -> {name:
    (value, floor, ok)}."""
    import numpy as np
    w = off["ampl"] * off["hm_mask"]
    dph = np.angle(np.exp(1j * (st["phse"] - off["phse"])))
    we = off["eenv_a"]
    dpe = np.angle(np.exp(1j * (st["eenv_p"] - off["eenv_p"])))
    f0_err = float(np.max(np.abs(st["f0"] - off["f0"])))
    out = {"f0 max err": (f0_err, 1e-3, f0_err <= 1e-3)}
    for name, floor in STREAM_SNR_FLOORS.items():
        v = ampl_snr(off[name], st[name])
        out[f"{name} snr"] = (v, floor, v >= floor)
    for name, v, lim in (
            ("phse err", float(np.sum(w * np.abs(dph)) / np.sum(w)), 0.05),
            ("eenv_p err", float(np.sum(we * np.abs(dpe)) / np.sum(we)), 0.1)):
        out[name] = (v, lim, v < lim)
    return out


def stream_analysis_phase(torch, kernels, mods, opt, rows):
    """Phase 15a, live analysis: RTAnalyzer (blocks of STREAM_BLOCK hops,
    STREAM_HALO of halo) over rows 0, 1 and 64 with the library default,
    counters zeroed before -> launches; the streamed frames against the
    port's offline analysis on the card; then with the denoiser off
    against test_rtanalyze's floors."""
    import numpy as np

    from libllsm2_tpu_torch.container import chunk_to_numpy, index_batch
    from libllsm2_tpu_torch.runtime.rtanalyze import RTAnalyzer
    layer0, = mods
    x, f0 = rows
    conf = opt.conf
    block_ms = []
    kernels.reset_launches()
    streamed = [stream_feed(torch, RTAnalyzer(opt, STREAM_BLOCK, STREAM_HALO),
                            x[i], f0[i], block_ms)
                for i in range(len(STREAM_ROWS))]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    phase("15a stream launches", all(launches[k] > 0 for k in ANALYSIS),
          f"the block analysis's kernels {ANALYSIS} launched: {launches}")
    opt_off = dataclasses.replace(opt, track_denoise=False)
    xt, ft = (torch.from_numpy(a).cuda() for a in (x, f0))
    off, off_nd = (layer0._analyze(o, xt, ft) for o in (opt, opt_off))
    nfrm = f0.shape[1]
    phase("15a stream frames", all(s.nfrm == nfrm for s in streamed),
          f"{[s.nfrm for s in streamed]} frames, offline {nfrm}")
    for i, row in enumerate(STREAM_ROWS):
        st = chunk_to_numpy(streamed[i])
        snr_on = ampl_snr(index_batch(off, i).ampl.cpu().numpy(), st["ampl"])
        snr_off = ampl_snr(index_batch(off_nd, i).ampl.cpu().numpy(),
                           st["ampl"])
        pin = STREAM_PINS_DB.get(row)
        ok = snr_off >= STREAM_DENOISE_MIN_DB and (
            pin is None or abs(snr_on - pin) <= STREAM_PIN_TOL_DB)
        phase(f"15a stream denoiser on row {row}", ok,
              f"ampl snr against the offline analysis {snr_on:.4f} dB"
              + (f" (JAX {pin:.4f} +- {STREAM_PIN_TOL_DB})" if pin else "")
              + f", against the offline analysis with the denoiser off "
              f"{snr_off:.4f} dB (>= {STREAM_DENOISE_MIN_DB})")
    for i, row in enumerate(STREAM_ROWS):
        st = chunk_to_numpy(stream_feed(
            torch, RTAnalyzer(opt_off, STREAM_BLOCK, STREAM_HALO), x[i], f0[i],
            []))
        res = stream_floors(st, chunk_to_numpy(index_batch(off_nd, i)))
        phase(f"15a stream denoiser off row {row}",
              all(ok for _, _, ok in res.values()),
              "; ".join(f"{k} {v:.4g} ({'<=' if 'err' in k else '>='} "
                        f"{lim:g})" for k, (v, lim, _) in res.items()))
    ms = statistics.median(block_ms)
    blk_s = STREAM_BLOCK * conf.thop
    lat = STREAM_BLOCK + 2 * STREAM_HALO
    phase("15a live analysis", True,
          f"{len(block_ms)} blocks of {STREAM_BLOCK + 2 * STREAM_HALO} "
          f"frames ({(STREAM_BLOCK + 2 * STREAM_HALO) * conf.nhop} samples,"
          f" a batch of one): {ms:.2f} ms a block (median; min "
          f"{min(block_ms):.2f}, max {max(block_ms):.2f}) = "
          f"{blk_s / (ms / 1e3):.1f} audio-sec/s of one stream; latency "
          f"{lat} hops = {lat * conf.thop * 1e3:g} ms")
    return launches


def drain_pool(pool, frames, timings):
    """Feed each stream POOL_FEED frames at a time, servicing as they come
    (tests/test_rtserve.py's drain), then end every stream -> each stream's
    audio (numpy) and the rendered streams of each tick."""
    import numpy as np
    outs = [[] for _ in frames]
    per_tick = []
    for p in range(0, max(map(len, frames)), POOL_FEED):
        for s, fr in enumerate(frames):
            if p < len(fr):
                pool.feed(s, fr[p:p + POOL_FEED])
        while True:
            n = pool.service(timings)
            if not n:
                break
            per_tick.append(n)
        for s in range(len(frames)):
            outs[s].append(pool.fetch(s, pool.readable(s)))
    ticks = pool.dispatches
    for s in range(len(frames)):
        pool.end_stream(s)
        outs[s].append(pool.fetch(s, pool.readable(s)))
    return [np.concatenate(o) for o in outs], per_tick, ticks


def tick_report(label, pool, timings, per_tick, conf, peak):
    """Print a pool's tick times (median ms: assembly, render, commit),
    its streams x realtime and latency."""
    tot = [sum(t.values()) for t in timings]
    med = {k: statistics.median(t[k] for t in timings)
           for k in ("assemble", "render", "commit")}
    audio = sum(per_tick) * pool.feed_block * conf.thop
    full = statistics.median(t for t, n in zip(tot, per_tick)
                             if n == pool.n_streams)
    tick_audio = pool.n_streams * pool.feed_block * conf.thop
    phase(f"{label} serving", True,
          f"{len(timings)} ticks, {pool.n_streams} streams x "
          f"{pool.feed_block} hops: {statistics.median(tot):.2f} ms a tick "
          f"(median; assembly {med['assemble']:.2f}, render "
          f"{med['render']:.2f}, commit {med['commit']:.2f}); ticks with "
          f"every stream due {full:.2f} ms = {tick_audio / (full / 1e3):.1f}"
          f" x realtime; all ticks {audio / (sum(tot) / 1e3):.1f} "
          f"audio-sec/s; latency {pool.feed_block + 1} hops = "
          f"{(pool.feed_block + 1) * conf.thop * 1e3:g} ms; peak "
          f"{peak:.3f} GiB")


def stream_serve_phase(torch, mods, opt, sopt, rows):
    """Phase 15b, serving: StreamPool(POOL_STREAMS, feed_block=POOL_BLOCK)
    over the port's offline chunks of POOL_ROWS."""
    import numpy as np

    from libllsm2_tpu_torch.container import index_batch
    from libllsm2_tpu_torch.runtime import rtsynth
    from libllsm2_tpu_torch.runtime.rtserve import StreamPool
    layer0, metrics = mods
    x, f0 = (torch.from_numpy(a).cuda() for a in rows)
    chunk = layer0._analyze(opt, x, f0)
    y_off = layer0._synthesize(sopt, chunk).y_sin.cpu().numpy()
    chunks = [index_batch(chunk, s) for s in range(len(POOL_ROWS))]
    frames = [rtsynth.RTSynthesizer.chunk_frames_np(c) for c in chunks]
    pool = StreamPool(sopt, opt.conf, n_streams=POOL_STREAMS,
                      feed_block=POOL_BLOCK)
    timings = []
    (y, per_tick, ticks), peak = peak_above(
        torch, lambda: drain_pool(pool, frames, timings))
    phase("15b one render a tick", ticks == len(timings),
          f"{ticks} renders in {len(timings)} ticks")
    for s in POOL_SOLO:
        so = dataclasses.replace(sopt, noise_seed=sopt.noise_seed + s)
        solo = rtsynth.stream_chunk(so, chunks[s], block=POOL_BLOCK)
        phase(f"15b stream {s} = solo", np.array_equal(y[s], solo),
              f"{len(y[s])} samples bit for bit against stream_chunk("
              f"block={POOL_BLOCK}) with noise seed {so.noise_seed}")
    snr = [metrics.snr_db(y_off[s], y[s]) for s in range(len(POOL_ROWS))]
    phase("15b streams against offline y_sin", min(snr) > POOL_SNR_MIN_DB,
          f"min {min(snr):.4f} dB (> {POOL_SNR_MIN_DB}), median "
          f"{statistics.median(snr):.4f}, rows 0/1 {snr[0]:.4f} / "
          f"{snr[1]:.4f}")
    frame = rtsynth.stream_chunk(sopt, chunks[0])
    err = float(np.max(np.abs(frame - y[0]))) if frame.shape == y[0].shape \
        else math.inf
    phase("15b row 0 frame by frame = feed_many", err <= FEED_TOL,
          f"max |diff| {err:.3g} (<= {FEED_TOL})")
    tick_report("15b", pool, timings, per_tick, opt.conf, peak)


def stream_pbp_phase(torch, mods, opt, sopt, l1):
    """Phase 15c, PbP serving: StreamPool(PBP_POOL_STREAMS, synth_mode=
    "pbp") over phase 10's layer-1 rows; then test_runtime.py's PbP
    stream on the card."""
    import numpy as np

    from libllsm2_tpu_torch.container import index_batch
    from libllsm2_tpu_torch.runtime import rtsynth
    from libllsm2_tpu_torch.runtime.rtserve import StreamPool
    from libllsm2_tpu_torch.utils import testsig
    layer0, layer1, pbp, metrics = mods
    chunks = [index_batch(l1, s) for s in range(PBP_POOL_STREAMS)]
    frames = [rtsynth.RTSynthesizer.chunk_frames_np(c) for c in chunks]
    pool = StreamPool(sopt, l1.conf, n_streams=PBP_POOL_STREAMS,
                      feed_block=POOL_BLOCK, synth_mode="pbp")
    timings = []
    (y, per_tick, ticks), peak = peak_above(
        torch, lambda: drain_pool(pool, frames, timings))
    phase("15c one frame and one pulse render a tick",
          ticks == 2 * len(timings), f"{ticks} renders in {len(timings)} "
          "ticks")
    same = []
    for s, c in enumerate(chunks):
        so = dataclasses.replace(sopt, noise_seed=sopt.noise_seed + s)
        same.append(np.array_equal(y[s], rtsynth.stream_chunk(
            so, c, block=POOL_BLOCK, synth_mode="pbp")))
    phase("15c every stream = solo", all(same),
          f"{sum(same)} of {len(same)} streams bit for bit against "
          f"stream_chunk(block={POOL_BLOCK}, synth_mode='pbp')")
    y_off = pbp.pbp_synthesize(sopt, l1.map(lambda a: a[:2])).y_sin
    for s, pin in PBP_STREAM_PINS_DB.items():
        snr = metrics.snr_db(y_off[s].cpu().numpy(), y[s])
        phase(f"15c stream {s} against offline pbp",
              abs(snr - pin) <= STREAM_PIN_TOL_DB,
              f"y_sin snr {snr:.4f} dB (JAX {pin:.4f} +- "
              f"{STREAM_PIN_TOL_DB})")
    # tests/test_runtime.py::test_stream_pbp_matches_offline on the card
    x, f0 = testsig.make_test_utterance(duration=0.6)
    ch = layer1.chunk_to_layer1(layer0.analyze(
        opt, x.astype(np.float32), f0.astype(np.float32)))
    snr = metrics.snr_db(pbp.pbp_synthesize(sopt, ch).y_sin.cpu().numpy(),
                         rtsynth.stream_chunk(sopt, ch, synth_mode="pbp"))
    phase("15c test_runtime's pbp stream", snr > PBP_SNR_MIN_DB,
          f"0.6 s make_test_utterance: y_sin snr {snr:.4f} dB against "
          f"offline pbp (> {PBP_SNR_MIN_DB})")
    tick_report("15c", pool, timings, per_tick, l1.conf, peak)


def stream_codec_phase(torch, mods, sopt, conf, v01):
    """Phase 15d, codec stream: phase 13's vectors of rows 0 and 1 decoded
    in blocks of 16 frames (decode_frames) into RTSynthesizer(phase_mode=
    "propagate") against the offline decode -> synthesize."""
    import numpy as np

    from libllsm2_tpu_torch.runtime import rtsynth
    layer0, coder = mods
    cc = coder.CoderConfig(conf=conf)
    for row in range(v01.shape[0]):
        v = v01[row]
        y_off = layer0.synthesize(sopt, coder.decode(cc, v)).y_sin
        y_off = y_off.cpu().numpy()
        rt = rtsynth.RTSynthesizer(sopt, conf, capacity_frames=v.shape[0] + 8,
                                   phase_mode="propagate")
        out = []
        t0 = time.perf_counter()
        for s in range(0, v.shape[0], 16):
            rt.feed_many(coder.decode_frames(cc, v[s:s + 16]))
            out.append(rt.fetch(rt.readable()))
        rt.flush()
        out.append(rt.fetch(rt.readable()))
        ms = (time.perf_counter() - t0) * 1e3
        y_st = np.concatenate(out)
        n = min(len(y_off), len(y_st))
        lo, hi = int(0.1 * n), int(0.9 * n)
        snr = 10.0 * math.log10(float(np.sum(y_off[lo:hi] ** 2)) / max(float(
            np.sum((y_off[lo:hi] - y_st[lo:hi]) ** 2)), 1e-12))
        phase(f"15d codec stream row {row}", snr > CODEC_STREAM_MIN_DB,
              f"y_sin snr against the offline decode {snr:.4f} dB (> "
              f"{CODEC_STREAM_MIN_DB}); {v.shape[0]} frames decoded and "
              f"streamed in {ms:.1f} ms")


def snr_db(torch, ref, y, fs, f0_floor):
    """Phase 8's SNR (scripts/port_jax_pins.py's): y against ref over the
    common length, minus an OLA margin of min(2 fs / f0_floor, n / 4) at
    both ends, in float64."""
    n = min(ref.shape[-1], y.shape[-1])
    m = min(int(2.0 * fs / f0_floor), n // 4)
    ref = ref[m:n - m].double()
    err = ref - y[m:n - m].double()
    return float(10.0 * torch.log10(torch.sum(ref ** 2)
                                    / torch.clamp(torch.sum(err ** 2),
                                                  min=1e-12)))


def public_11025(torch, kernels, lt, dev):
    """Phase 8: one noisy and one clean 1 s row made at 11025 Hz through
    the public analyze -> synthesize."""
    from libllsm2_tpu_torch.utils import testsig
    fs = 11025.0
    opt = lt.create_aoptions(fs=fs, f0_floor=70.0, use_pallas=True)
    sopt = dataclasses.replace(lt.create_soptions(fs=fs), use_pallas=True)
    kernels.reset_launches()
    for seed, pin in PUBLIC_11025_PINS_DB.items():
        x, f0, x_ref = (v.astype("float32")
                        for v in testsig.make_test_utterance(
                            duration=1.0, fs=fs, seed=seed,
                            noise_level=0.05 if seed < N_NOISY else 0.0,
                            return_parts=True))
        chunk = lt.analyze(opt, x, f0)          # numpy: on the card by default
        phase(f"8 public 11025 Hz seed {seed} device",
              chunk.ampl.device == dev, f"numpy input analyzed on "
              f"{chunk.ampl.device}")
        out = lt.synthesize(sopt, chunk)
        x_ref = torch.tensor(x_ref, device=dev)
        torch.cuda.synchronize()
        ny = int(round(chunk.nfrm * opt.conf.thop * fs))
        phase(f"8 public 11025 Hz seed {seed} output",
              all(tuple(v.shape) == (ny,) and bool(torch.isfinite(v).all())
                  for v in out[:3]),
              f"y, y_sin, y_nos {tuple(out.y.shape)} finite (expected "
              f"({ny},) = round(nfrm thop fs)); analysis at "
              f"{opt.conf.fs} Hz, hop {opt.conf.nhop}")
        snr = snr_db(torch, x_ref, out.y_sin, fs, opt.conf.f0_floor)
        phase(f"8 public 11025 Hz seed {seed} snr",
              abs(snr - pin) <= PUBLIC_TOL_DB,
              f"{snr:.4f} dB (JAX {pin:.4f} +- {PUBLIC_TOL_DB})")
    launches = dict(kernels.LAUNCHES)
    phase("8 launches", launches["refine_f0_full"] > 0
          and launches["harmonic_project"] == 0, str(launches))


# ---------------------------------------------------------------------------
# phase 16: the rest of the DSP kit and every option of the JAX package
# ---------------------------------------------------------------------------

def plain_launches_ok(launches):
    """use_pallas=False launches only the noise draw and the cycle track:
    -> (ok, the launched kernels)."""
    launched = {k for k, v in launches.items() if v}
    return launched <= set(PLAIN_KERNELS) and bool(launched), launched


def steps_ms(torch, fn, reps):
    """fn() once to warm up, then reps synchronized runs -> (median ms,
    [ms, ...])."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def library_default_phase(torch, kernels, mods, data, opts):
    """16a: the library default (opt, sopt: use_pallas=False) at full width
    on the bench rows, beside the kernel path (opt_k, sopt_k) -> (the
    counted run's launches, the step's median ms, its peak GiB)."""
    layer0, corpus = mods
    x, f0, x_ref, nxv = data
    B = x.shape[0]
    opt, sopt, opt_k, sopt_k = opts
    kernels.reset_launches()
    y, snr, _ = corpus.batched_pipeline(opt, sopt, x, f0, nxv, x_ref)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    ok, launched = plain_launches_ok(launches)
    phase("16a library default launches", ok,
          f"launched {sorted(launched)} only (allowed: {PLAIN_KERNELS}; "
          f"none of the Pallas counterparts); {launches}")
    phase("16a library default output", tuple(y.shape) == tuple(x.shape)
          and y.device.type == "cuda" and bool(torch.isfinite(y).all()),
          f"y {tuple(y.shape)} on {y.device}, finite")
    snr = snr.cpu().tolist()
    check_snr("16a library default", snr, DSPKIT_PINS_DB, None,
              L0_NOISY_TOL_DB)
    del y
    step = lambda o, so: corpus.batched_pipeline(o, so, x, f0, nxv, x_ref)
    torch.cuda.reset_peak_memory_stats()
    plain_ms, plain_runs = steps_ms(torch, lambda: step(opt, sopt),
                                    DSPKIT_STEP_REPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    chunk, peak_a = peak_above(torch, lambda: layer0._analyze(opt, x, f0))
    _, peak_s = peak_above(torch, lambda: layer0._synthesize(sopt, chunk))
    ms_a = synced_ms(torch, lambda: layer0._analyze(opt, x, f0), 1)
    ms_s = synced_ms(torch, lambda: layer0._synthesize(sopt, chunk), 1)
    kernel_ms, kernel_runs = steps_ms(torch, lambda: step(opt_k, sopt_k),
                                      DSPKIT_STEP_REPS)
    phase("16a library default step", True,
          f"{B} x {DURATION} s use_pallas=False: median {plain_ms:.2f} ms of "
          f"{[round(t, 2) for t in plain_runs]} ms, "
          f"{B * DURATION / plain_ms * 1e3:.1f} audio-sec/s, peak {peak:.2f} "
          f"GiB; analysis {ms_a:.2f} ms (peak {peak_a:.2f} GiB above its "
          f"inputs), synthesis {ms_s:.2f} ms ({peak_s:.2f} GiB); the kernel "
          f"path (use_pallas=True) median {kernel_ms:.2f} ms of "
          f"{[round(t, 2) for t in kernel_runs]} ms: the kernels save "
          f"x{plain_ms / kernel_ms:.1f}")
    del chunk
    torch.cuda.empty_cache()
    check_rows("16a library default", *rows_alone(
        torch, [("analyze", lambda a: fields(layer0._analyze(opt, a[0], a[1]),
                                             ("f0", "ampl", "phse", "hm_mask",
                                              "psd", "edc", "eenv_a",
                                              "eenv_p"))),
                ("synthesize", lambda c: outputs(layer0._synthesize(sopt, c)))],
        _Rows((x, f0))))
    torch.cuda.empty_cache()
    return launches, plain_ms, peak


class _Rows(tuple):
    """A tuple of batch tensors that rows_alone can cut to one row."""

    def map(self, fn):
        return _Rows(fn(t) for t in self)


def analysis_options_phase(torch, kernels, mods, data, opt_k, sopt_k):
    """16b: the analysis options with the kernels on, on the bench rows ->
    ({option: launches}, the polar denoise_stats calls' cases, frame
    chunk ok)."""
    harmonics, layer0, corpus = mods
    x, f0, x_ref, nxv = data
    B = x.shape[0]
    conf = opt_k.conf
    out = {}
    polar = None
    for label, change in DSPKIT_OPTIONS.items():
        opt = dataclasses.replace(opt_k, **change)
        kernels.reset_launches()
        names = ("denoise_stats",) if polar is None else ()
        calls, (y, snr, _) = capture_kernel_inputs(
            kernels, names,
            lambda: corpus.batched_pipeline(opt, sopt_k, x, f0, nxv, x_ref))
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        need = DSPKIT_OPTION_KERNELS[label]
        skip = () if "deconv_full" in need else ("deconv_full",)
        phase(f"16b {label} launches", all(launches[k] > 0 for k in need)
              and all(launches[k] == 0 for k in skip),
              f"{need} launched, {skip or 'nothing'} skipped: {launches}")
        phase(f"16b {label} output", tuple(y.shape) == tuple(x.shape)
              and bool(torch.isfinite(y).all()), f"y {tuple(y.shape)} finite")
        snr = snr.cpu().tolist()
        for row, pin in DSPKIT_OPTION_PINS_DB[label].items():
            phase(f"16b {label} snr row {row}",
                  abs(snr[row] - pin) <= L0_NOISY_TOL_DB,
                  f"{snr[row]:.4f} dB (JAX {pin:.4f} +- {L0_NOISY_TOL_DB})")
        del y
        if names:
            polar = calls["denoise_stats"]
            phase(f"16b {label} denoiser input", len(polar) == 1 and
                  not polar[0][1].get("complex_input", False),
                  "denoise_stats called once with polar (ampl, phse) input")
        torch.cuda.reset_peak_memory_stats()
        ms, runs = steps_ms(torch, lambda: corpus.batched_pipeline(
            opt, sopt_k, x, f0, nxv, x_ref), DSPKIT_OPTION_REPS)
        print(f"16b {label}: {B} x {DURATION} s step median {ms:.2f} ms of "
              f"{[round(t, 2) for t in runs]} ms; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches {launches}", flush=True)
        out[label] = launches
    # frame_chunk: the chunk equals the unchunked one; the chunked main
    # projection peaks lower
    opt_fc = dataclasses.replace(opt_k, **DSPKIT_OPTIONS["frame_chunk 64"])
    a, b = layer0._analyze(opt_k, x, f0), layer0._analyze(opt_fc, x, f0)
    err = {k: float((getattr(a, k) - getattr(b, k)).abs().max()
                    / getattr(a, k).abs().max().clamp(min=1e-30))
           for k in ("ampl", "psd", "edc", "eenv_a")}
    err["phse"] = float((torch.polar(a.ampl, a.phse)
                         - torch.polar(b.ampl, b.phse)).abs().max()
                        / a.ampl.abs().max())
    del a, b
    cyc = harmonics.sample_cycles(f0, conf.nhop, conf.fs, x.shape[-1])
    kw = dict(nhop=conf.nhop, fs=conf.fs, max_k=conf.maxnhar,
              halfwin_max=conf.halfwin_max, rel_winsize=conf.rel_winsize,
              fnyq=conf.fnyq)
    _, p_whole = peak_above(torch, lambda: harmonics.harmonic_analysis(
        x, f0, cyc, **kw))
    _, p_chunk = peak_above(torch, lambda: harmonics.harmonic_analysis(
        x, f0, cyc, frame_chunk=64, **kw))
    phase("16b frame_chunk = unchunked", max(err.values()) <= FRAME_CHUNK_TOL
          and p_chunk < p_whole,
          f"max |difference| / field peak {err} (tol {FRAME_CHUNK_TOL}); the "
          f"main projection's peak above its inputs {p_chunk:.3f} GiB chunked "
          f"against {p_whole:.3f} GiB whole")
    del cyc
    opt_pp = dataclasses.replace(opt_k, **DSPKIT_OPTIONS["pp"])
    check_rows("16b pp", *rows_alone(
        torch, [("analyze", lambda r: fields(
            layer0._analyze(opt_pp, r[0], r[1]),
            ("f0", "ampl", "phse", "hm_mask", "psd", "edc", "eenv_a",
             "eenv_p")))], _Rows((x, f0))))
    torch.cuda.empty_cache()
    return out, polar


def synthesis_phase(torch, kernels, mods, data, opt_k, sopt_k):
    """16c: noise_idft="fft" with the kernels on and off against the
    matmul path, and the segment-input noise_mod_ola entry against its
    twin -> (its cases, full-batch records, launches)."""
    layer0, = mods
    x, f0 = data[:2]
    chunk = layer0._analyze(opt_k, x, f0)
    launches = {}
    calls = None
    for up in (True, False):
        so = dataclasses.replace(sopt_k, use_pallas=up)
        ref = layer0._synthesize(so, chunk).y_nos
        kernels.reset_launches()
        fft = dataclasses.replace(so, noise_idft="fft")
        if up:
            calls, got = capture_kernel_inputs(
                kernels, ("noise_mod_ola_seg",),
                lambda: layer0._synthesize(fft, chunk))
            got = got.y_nos
        else:
            got = layer0._synthesize(fft, chunk).y_nos
        torch.cuda.synchronize()
        launches[up] = dict(kernels.LAUNCHES)
        rms = float(torch.sqrt(torch.mean(ref.double() ** 2)))
        err = float(torch.sqrt(torch.mean((got.double() - ref.double()) ** 2)))
        ms, _ = steps_ms(torch, lambda: layer0._synthesize(fft, chunk), 3)
        ms_m, _ = steps_ms(torch, lambda: layer0._synthesize(so, chunk), 3)
        phase(f"16c noise_idft=fft use_pallas={up}",
              err <= NOISE_IDFT_TOL * rms and (
                  launches[up]["noise_mod_ola_seg"] == 1 if up
                  else plain_launches_ok(launches[up])[0]),
              f"y_nos rms error {err:.3e} against the matmul path's (tol "
              f"{NOISE_IDFT_TOL} x rms {rms:.4f}); synthesis {ms:.2f} ms "
              f"(matmul {ms_m:.2f} ms); launches {launches[up]}")
    cases = []
    for i, (args, kw) in enumerate(calls["noise_mod_ola_seg"]):
        cases.append(check_kernel(torch, kernels, "noise_mod_ola_seg",
                                  SEG_KERNEL[2], args, kw, f"fft {i}",
                                  library=not cases))
    full = full_batch(torch, kernels, calls, "16c")
    del chunk, calls
    torch.cuda.empty_cache()
    return cases, full["noise_mod_ola_seg"], launches[True]


def leaf_ops_phase(torch, x):
    """16d: the leaf DSP kit on the card against the CPU on the bench rows
    x [B, nx] (a subset of rows on the CPU where a call there is slow, as
    each line says), each op's time on the card; biquad, a loop over the
    samples, timed at 1 s and 8 s on one row and on all rows."""
    import numpy as np
    from libllsm2_tpu_torch.ops import filters, spectral, stft
    B, nx = x.shape
    xc = x.cpu()
    fir = filters.fir1_bandpass(127, 300.0, 3400.0, 16000.0)
    b, a = (0.0675, 0.135, 0.0675), (1.0, -1.143, 0.4128)
    hw = torch.full((B, nx // 80), 200.0)
    centers = torch.arange(nx // 80) * 80
    freqs = torch.full((B, nx // 80), 150.0)
    win = torch.tensor(np.hanning(1024), dtype=torch.float32)
    # LPC of a harmonic frame is ill-conditioned (a 1e-6 change of the
    # input moves its order-16 coefficients by ~20%): white noise at 0.1 of
    # each row's rms, seeded and the same on both devices, conditions it
    seg = xc[:, :1024]
    noisy = (seg + 0.1 * seg.std(dim=-1, keepdim=True) * torch.randn(
        seg.shape, generator=torch.Generator().manual_seed(0))) * win
    ops = [
        ("czt", lambda v: spectral.czt(v, 2048, 1.0 / 4096), B),
        ("iczt", lambda v: spectral.iczt(spectral.czt(v[..., :8192], 8192,
                                                      1.0 / 8192),
                                         1.0 / 8192), B),
        ("stft/istft", lambda v: stft.istft(stft.stft(v, 512, 128), 512, 128,
                                            v.shape[-1]), B),
        ("fftfilt", lambda v: filters.fftfilt(fir.to(v.device), v), B),
        ("lpc_from_signal", lambda v: filters.lpc_from_signal(
            noisy[:v.shape[0]].to(v.device), 16)[0], B),
        ("instantaneous_frequency", lambda v: spectral.instantaneous_frequency(
            v, centers.to(v.device), freqs[:v.shape[0]].to(v.device),
            fs=16000.0, halfwidth=hw[:v.shape[0]].to(v.device),
            halfwin_max=256), LEAF_CPU_ROWS),
        ("biquad 1 s", lambda v: filters.biquad(v[..., :16000], b, a), B),
    ]
    for name, fn, rows in ops:
        got = fn(x)
        ref = fn(xc[:rows])
        torch.cuda.synchronize()
        got = got[:rows].cpu()
        err = float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30))
        ms = (once_ms(torch, lambda: fn(x)) if name.startswith("biquad")
              else cuda_ms(torch, lambda: fn(x), 5))
        phase(f"16d {name}", err <= LEAF_TOL, f"{B} x {nx / 16000.0} s rows: "
              f"card against the CPU (rows 0-{rows - 1}) max |difference| / "
              f"peak {err:.3e} (tol {LEAF_TOL}); {ms:.3f} ms on the card")
    # the biquad is a loop of a few launches a sample whatever the rows:
    # each length and batch timed once (no warm-up run: ~6 s at 8 s)
    for secs in (1, 8):
        for rows in (1, B):
            v = x[:rows, :secs * 16000]
            ms = once_ms(torch, lambda: filters.biquad(v, b, a))
            print(f"16d biquad {secs} s x {rows} row(s): {ms:.1f} ms on the "
                  f"card (a step a sample: {secs * 16000} steps)", flush=True)


# ---------------------------------------------------------------------------
# phases 17 and 18: the learned models (cell tts-train-serve) and the
# single-device edges (cell cli-fp64)
# ---------------------------------------------------------------------------

def _slot(cc, name):
    for n, off, size in cc.layout():
        if n == name:
            return slice(off, off + size)
    raise KeyError(name)


def _train_steps(torch, step, n):
    """n synchronized calls of step() -> (losses, median ms a step)."""
    losses, times = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        loss = step()
        losses.append(float(loss))            # synchronizes
        times.append((time.perf_counter() - t0) * 1e3)
    return losses, statistics.median(times)


def _f0_rel_err(np, f0_in, f0_out):
    v = f0_in > 0
    return float(np.median(np.abs(f0_out[v] - f0_in[v]) / f0_in[v]))


def _sentence(np, seq, durs):
    """A phone sentence's model inputs (ids [1, N], feats [1, N, 2])."""
    N = sum(durs)
    ids = np.zeros((1, N), np.int32)
    feats = np.zeros((1, N, 2), np.float32)
    a = 0
    for pi, d in zip(seq, durs):
        ids[0, a:a + d] = pi
        feats[0, a:a + d, 0] = (np.arange(d) + 0.5) / d
        a += d
    feats[0, :, 1] = np.arange(N) / (N - 1)
    return ids, feats


def tts_phase(torch, kernels, dev, opt_k, sopt_k):
    """17a-b (cell tts-train-serve): the TTS corpus through the kernels,
    the acoustic model trained on the card at its default widths, its
    held-out floors, the served and the offline render -> {"17a":
    launches, "17b": launches of the offline render}."""
    import numpy as np
    from scipy import signal as sps

    from libllsm2_tpu_torch import create_aoptions, create_soptions
    from libllsm2_tpu_torch.models import acoustic, coder, layer0, neural
    from libllsm2_tpu_torch.runtime import rtsynth
    from libllsm2_tpu_torch.utils import ttsdata
    out = {}
    # 17a: the corpus, the kernels on, counters zeroed before
    kernels.reset_launches()
    t0 = time.perf_counter()
    corp = ttsdata.build_corpus(TTS_UTTS, opt=opt_k, seed=0, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out["17a"] = launches = dict(kernels.LAUNCHES)
    cc = corp["cc"]
    phase("17a corpus launches", all(launches[k] > 0 for k in
                                     ANALYSIS + (VITERBI,)),
          f"{sorted(ANALYSIS + (VITERBI,))} launched: {launches}")
    B, N, D = corp["targets"].shape
    phase("17a corpus", (B, N, D) == (TTS_UTTS, TTS_FRAMES, cc.dims)
          and np.isfinite(corp["targets"]).all(),
          f"{TTS_UTTS} utterances x {N} frames, {D}-dim targets finite; "
          f"built in {secs:.2f} s ({secs / TTS_UTTS * 1e3:.1f} ms an "
          "utterance: render on the host, analysis on the card, kernels "
          "on)")
    t0 = time.perf_counter()
    ttsdata.build_corpus(1, seed=0, device=dev)          # library default
    torch.cuda.synchronize()
    print(f"17a one utterance with the library default (use_pallas=False): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)

    # 17b: the acoustic model at its default widths, the demo's 400 steps
    norm = neural.Normalizer(corp["targets"].reshape(-1, D))
    cfg = acoustic.AcousticConfig(dims=D, n_phones=ttsdata.N_PHONES)
    params = acoustic.init_params(cfg, torch.Generator().manual_seed(0),
                                  device=dev)
    opt_state = acoustic.make_optimizer(cfg, params)
    batch = tuple(torch.tensor(a, device=dev) for a in (
        corp["ids"], corp["feats"],
        norm.fwd(corp["targets"]).astype(np.float32), corp["mask"]))
    w = torch.ones(D, device=dev)
    w[_slot(cc, "f0")] = 4.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = _train_steps(torch, lambda: acoustic.train_step(
        cfg, params, opt_state, batch, w)[2], TTS_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    phase("17b acoustic training", losses[-1] < 0.2 * losses[0],
          f"{TTS_STEPS} steps on {B} x {N} frames (hidden {cfg.hidden}, "
          f"dilations {cfg.dilations}): {ms:.3f} ms a step (median), loss "
          f"{losses[0]:.4f} -> {losses[-1]:.5f} (< 0.2x), peak {peak:.3f} "
          "GiB")
    held = ttsdata.build_corpus(2, opt=opt_k, seed=99, total_frames=192,
                                n_seg=(5, 8), dur=(16, 34), device=dev)
    pred = acoustic.predict_vectors(cfg, params, held["ids"], held["feats"],
                                    norm)
    f0_pred, f0_true = pred[..., _slot(cc, "f0")][..., 0], held["f0"]
    v = f0_true > 0
    err = _f0_rel_err(np, f0_true, f0_pred)
    c = float(np.corrcoef(f0_pred[v], f0_true[v])[0, 1])
    phase("17b held-out F0", v.sum() > 50 and err < 0.05 and c > 0.85,
          f"{int(v.sum())} voiced frames: median relative error {err:.4f} "
          f"(< 0.05), correlation {c:.4f} (> 0.85)")
    sl = _slot(cc, "vtmagn")
    feat = lambda a: a[..., sl] - a[..., sl].mean(axis=-1, keepdims=True)
    vowels = [i for i, ph in enumerate(ttsdata.PHONE_SET)
              if ph.kind == "vowel"]
    pos = corp["feats"][..., 0]
    cents = {p: feat(corp["targets"][(corp["ids"] == p) & (pos > 0.3)
                                     & (pos < 0.7)]).mean(axis=0)
             for p in vowels}
    held = ttsdata.build_corpus(2, opt=opt_k, seed=123, total_frames=192,
                                device=dev)
    pred = acoustic.predict_vectors(cfg, params, held["ids"], held["feats"],
                                    norm)
    mid = (held["feats"][..., 0] > 0.3) & (held["feats"][..., 0] < 0.7)
    hits = tot = 0
    for p in vowels:
        for vec in feat(pred[(held["ids"] == p) & mid]):
            d = {q: np.linalg.norm(vec - c) for q, c in cents.items()}
            hits += min(d, key=d.get) == p
            tot += 1
    phase("17b held-out vowel identity", tot > 30 and hits / tot > 0.75,
          f"{hits} of {tot} mid-vowel frames nearest their own vowel "
          f"({hits / max(tot, 1):.4f} > 0.75)")

    # serving: an unseen sentence through decode_frames -> RTSynthesizer
    fs, nhop = cc.conf.fs, cc.conf.nhop
    ids, feats = _sentence(np, [1, 6, 2, 0], [56, 40, 56, 40])
    Ns = ids.shape[1]
    pred = acoustic.predict_vectors(cfg, params, ids, feats, norm,
                                    unvoiced_below=cc.conf.f0_floor)[0]
    rt = rtsynth.RTSynthesizer(create_soptions(), cc.conf,
                               capacity_frames=Ns + 8,
                               phase_mode="propagate", device=dev)
    t0 = time.perf_counter()
    ys = []
    for s in range(0, Ns, 16):
        rt.feed_many(coder.decode_frames(cc, pred[s:s + 16], device=dev))
        ys.append(rt.fetch(rt.readable()))
    rt.flush()
    ys.append(rt.fetch(rt.readable()))
    serve_ms = (time.perf_counter() - t0) * 1e3
    y = np.concatenate(ys)
    mid = slice(20 * nhop, 48 * nhop)
    f0m = float(np.median(pred[20:48, 0]))
    seg = y[mid] - y[mid].mean()
    lag = int(round(fs / max(f0m, 1.0)))
    r = np.correlate(seg, seg, "full")[len(seg) - 1:]
    per = float(r[lag - 2:lag + 3].max() / max(r[0], 1e-12))
    f, P = sps.welch(y[(56 + 8) * nhop:(56 + 36) * nhop], fs=fs, nperseg=512)
    cent = float((f * P).sum() / max(P.sum(), 1e-12))
    quiet = float(np.std(y[(Ns - 24) * nhop:(Ns - 4) * nhop])
                  / max(np.std(y[mid]), 1e-12))
    phase("17b served sentence", np.isfinite(y).all() and f0m > 80.0
          and per > 0.4 and cent > 2500.0 and quiet < 0.1,
          f"[aa s iy sil] {Ns} frames in {serve_ms:.1f} ms (16-frame blocks): "
          f"'aa' periodicity {per:.3f} at F0 {f0m:.1f} Hz (> 0.4, > 80 Hz), "
          f"'s' centroid {cent:.0f} Hz (> 2500), silence {quiet:.4f} of the "
          "vowel's std (< 0.1)")
    kernels.reset_launches()
    res = layer0.synthesize(sopt_k, coder.decode(cc, pred, device=dev))
    torch.cuda.synchronize()
    out["17b"] = launches = dict(kernels.LAUNCHES)
    phase("17b offline render", all(launches[k] > 0 for k in CODEC_KERNELS)
          and res.y.shape[-1] == Ns * nhop
          and bool(torch.isfinite(res.y).all()),
          f"coder.decode -> layer0.synthesize (kernels on): y "
          f"{tuple(res.y.shape)} finite; {launches}")
    return out


def learned_codec_phase(torch, kernels, vec, cc, sopt_k):
    """17c: the AE and the VQ codec at their default widths on the coder
    vectors vec [B, N, dims] (phase 13's chunk) at full batch; the token
    render's MCD on rows 0/1 through the kernels -> launches of that
    render."""
    import numpy as np

    from libllsm2_tpu_torch.models import coder, layer0, neural, vq
    from libllsm2_tpu_torch.utils import metrics
    B, N, D = vec.shape
    data = vec.reshape(-1, D).cpu().numpy()
    norm = neural.Normalizer(data)
    dn = torch.tensor(norm.fwd(data).astype(np.float32), device=vec.device)
    gen = lambda: torch.Generator().manual_seed(0)

    cfg = neural.AEConfig(dims=D, lr=AE_LR)
    params = neural.init_params(cfg, gen(), device=vec.device)
    opt_state = neural.make_optimizer(cfg, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = _train_steps(torch, lambda: neural.train_step(
        cfg, params, opt_state, dn)[2], AE_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    recon = norm.inv(neural.forward(cfg, params, dn).detach().cpu().numpy())
    err = _f0_rel_err(np, data[:, 0], recon[:, 0])
    phase("17c AE", losses[59] < 0.3 * losses[0] and err < 0.15,
          f"{B * N} vectors at full batch (hidden {cfg.hidden}, latent "
          f"{cfg.latent}, depth {cfg.depth}, lr {cfg.lr}): {ms:.3f} ms a "
          f"step (median of {AE_STEPS}), loss {losses[0]:.4f} -> "
          f"{losses[59]:.4f} after 60 steps (< 0.3x), F0 median relative "
          f"error {err:.4f} after {AE_STEPS} (< 0.15); peak {peak:.3f} GiB")
    del params, opt_state, recon
    cfg = vq.VQConfig(dims=D, lr=VQ_LR)
    params = vq.init_params(cfg, gen(), device=vec.device)
    opt_state = vq.make_optimizer(cfg, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    recs, ms = _train_steps(torch, lambda: vq.train_step(
        cfg, params, opt_state, dn)[2], VQ_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = vq.encode_tokens(cfg, params, dn)
    used = [len(torch.unique(tokens[:, g])) for g in range(cfg.groups)]
    back = norm.inv(vq.decode_tokens(cfg, params, tokens).cpu().numpy())
    voiced = data[:, 0] > 0
    agree = float(((back[:, 0] > 50.0) == voiced).mean())
    m = voiced & (back[:, 0] > 50.0)
    rel = float(np.median(np.abs(back[m, 0] - data[m, 0]) / data[m, 0]))
    phase("17c VQ", recs[-1] < 0.4 * recs[0] and min(used) >= 8
          and agree > 0.9 and rel < 0.05,
          f"{cfg.groups} x {cfg.codebook} codes ({cfg.bits_per_frame} bits "
          f"a frame), hidden {cfg.hidden}, latent {cfg.latent}, lr "
          f"{cfg.lr}: {ms:.3f} ms a step (median of {VQ_STEPS}), recon "
          f"{recs[0]:.4f} -> {recs[-1]:.4f} (< 0.4x), codes used a group "
          f"{used} (>= 8), voicing agreement {agree:.4f} (> 0.9), F0 median "
          f"relative error {rel:.4f} (< 0.05); peak {peak:.3f} GiB")
    # the token render against the float render, rows 0/1, kernels on
    v01 = data.reshape(B, N, D)[:2]
    back01 = back.reshape(B, N, D)[:2].astype(np.float32)
    kernels.reset_launches()
    y_ref = layer0.synthesize_batch(sopt_k, coder.decode(
        cc, v01, device=vec.device)).y_sin.cpu().numpy()
    y_vq = layer0.synthesize_batch(sopt_k, coder.decode(
        cc, back01, device=vec.device)).y_sin.cpu().numpy()
    launches = dict(kernels.LAUNCHES)
    mcd = [metrics.mel_cepstral_distortion_db(y_ref[b], y_vq[b],
                                              fs=cc.conf.fs)
           for b in range(2)]
    phase("17c VQ token render", max(mcd) < 2.5
          and all(launches[k] > 0 for k in CODEC_KERNELS),
          f"MCD of rows 0/1 {mcd[0]:.4f} / {mcd[1]:.4f} dB (< 2.5) against "
          f"the float decode, both rendered through the kernels: {launches}")
    return launches


def learned_pins(np):
    """LEARNED_PINS -> (arrays, {model: JAX pytree}) with each leaf its
    8-bit codes times its scale, in float32."""
    with np.load(LEARNED_PINS) as z:
        arrays = {k: z[k] for k in z.files}
    trees = {}
    for k, a in arrays.items():
        if "/" not in k or k.endswith("@scale"):
            continue
        node = trees
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a.astype(np.float32) * arrays[k + "@scale"]
    return arrays, trees


def jax_weights_check(torch, dev):
    """17d: the JAX package's weights (scripts/port_jax_pins_learned.npz)
    through params_from_jax on `dev`: forwards within LEARNED_FWD_TOL of
    scale, tokens >= LEARNED_TOKENS_MIN equal, LEARNED_STEPS AdamW steps'
    losses within LEARNED_LOSS_RTOL of JAX's."""
    import numpy as np

    from libllsm2_tpu_torch.models import acoustic, neural, vq
    from libllsm2_tpu_torch.utils import ttsdata
    z, trees = learned_pins(np)
    x = torch.tensor(z["x"], device=dev)
    D = x.shape[-1]
    report = []

    def close(name, got, ref, rows=None):
        got = got.detach().cpu().numpy()
        if rows is not None:
            got, ref = got[rows], ref[rows]
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        report.append(f"{name} forward {err:.2e}")
        return err <= LEARNED_FWD_TOL

    def trained(step, cfg, model, opt, *args):
        losses = [float(step(cfg, model, opt, *args)[2])
                  for _ in range(LEARNED_STEPS)]
        return losses

    def losses_ok(name, got):
        ref = z[name + "_losses"]
        rel = float(np.max(np.abs(np.asarray(got) - ref) / np.abs(ref)))
        report.append(f"{name} losses {rel:.2e}")
        return rel <= LEARNED_LOSS_RTOL

    ok = True
    cfg = neural.AEConfig(dims=D)
    m = neural.params_from_jax(cfg, trees["ae"], device=dev)
    ok &= close("ae", neural.forward(cfg, m, x), z["ae_forward"])
    ok &= losses_ok("ae", trained(neural.train_step, cfg, m,
                                  neural.make_optimizer(cfg, m), x))
    cfg = vq.VQConfig(dims=D)
    m = vq.params_from_jax(cfg, trees["vq"], device=dev)
    tok = vq.encode_tokens(cfg, m, x).cpu().numpy()
    same = float((tok == z["vq_tokens"]).mean())
    report.append(f"vq tokens {same * 100:.3f}% equal")
    ok &= same >= LEARNED_TOKENS_MIN
    rows = (tok == z["vq_tokens"]).all(axis=-1)
    ok &= close("vq", vq.forward(cfg, m, x)[0], z["vq_forward"], rows)
    ok &= losses_ok("vq", trained(vq.train_step, cfg, m,
                                  vq.make_optimizer(cfg, m), x))
    cfg = acoustic.AcousticConfig(dims=D, n_phones=ttsdata.N_PHONES)
    m = acoustic.params_from_jax(cfg, trees["acoustic"], device=dev)
    batch = tuple(torch.tensor(z[k], device=dev)
                  for k in ("ids", "feats", "targets", "mask"))
    ok &= close("acoustic", acoustic.forward(cfg, m, *batch[:2]),
                z["acoustic_forward"])
    w = torch.ones(D, device=dev)
    w[0] = 4.0
    ok &= losses_ok("acoustic", trained(acoustic.train_step, cfg, m,
                                        acoustic.make_optimizer(cfg, m),
                                        batch, w))
    return bool(ok), "; ".join(report)


def abs_phase(torch, data, dev):
    """17e: abs_refine on tests/test_abs.py's weakened analysis (floors and
    the JAX package's snr_after), then bench row 64 at 8 s alone."""
    import numpy as np

    from libllsm2_tpu_torch import create_aoptions, create_soptions
    from libllsm2_tpu_torch.models import abs as absmod
    from libllsm2_tpu_torch.models import layer0
    from libllsm2_tpu_torch.utils import testsig
    weak = dataclasses.replace(create_aoptions(), hm_passes=1,
                               hm_correction="none")
    sopt = create_soptions()

    def snr(ref, c):
        y = layer0.synthesize(sopt, c).y_sin.cpu().numpy()
        n = min(len(ref), len(y))
        lo, hi = int(0.05 * n), int(0.95 * n)
        e = ref[lo:hi] - y[lo:hi]
        return float(10 * np.log10(np.sum(ref[lo:hi] ** 2)
                                   / max(np.sum(e ** 2), 1e-20)))
    x, f0, xh = testsig.synth_hard_utterance(
        duration=0.6, register="female", seed=3, jitter=0.01, shimmer=0.1,
        noise_level=0.0, burst=False, unvoiced_tail_frac=0.0)
    chunk = layer0.analyze(weak, x, f0, device=dev)
    before = snr(xh, chunk)
    refined, losses = absmod.abs_refine(sopt, chunk, x, n_steps=100, lr=0.1)
    after = snr(xh, refined)
    losses = losses.cpu().numpy()
    zero = float((refined.ampl * (1 - chunk.hm_mask)).abs().max())
    phase("17e abs floors", losses[-1] < 0.95 * losses[0]
          and after > before + 6.0 and zero == 0.0
          and abs(after - ABS_SNR_PIN_DB) <= ABS_SNR_TOL_DB,
          f"test_abs fixture: loss {losses[0]:.6f} -> {losses[-1]:.6f} "
          f"(< 0.95x), SNR {before:.4f} -> {after:.4f} dB (+6 dB; JAX "
          f"{ABS_SNR_PIN_DB:.4f} +- {ABS_SNR_TOL_DB}), masked slots max "
          f"{zero}")
    # bench row 64 (clean) at 8 s alone, from the weak analysis
    x64, f064, ref64 = (d[64] for d in data[:3])
    chunk = layer0.analyze(weak, x64, f064)
    before = snr(ref64.cpu().numpy(), chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    refined, losses = absmod.abs_refine(sopt, chunk, x64, n_steps=100,
                                        lr=0.1)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 100
    peak = torch.cuda.max_memory_allocated() / 2**30
    after = snr(ref64.cpu().numpy(), refined)
    phase("17e abs bench row 64", bool(torch.isfinite(losses).all())
          and after > before,
          f"{DURATION} s, {chunk.nfrm} frames x {chunk.ampl.shape[-1]} "
          f"harmonics, 100 steps at lr 0.1: {ms:.2f} ms a step, peak "
          f"{peak:.3f} GiB; SNR {before:.4f} -> {after:.4f} dB")


FP64_CHILD = r'''
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
import libllsm2_tpu_torch as lt
from libllsm2_tpu_torch import fp
from libllsm2_tpu_torch.models import layer0
from libllsm2_tpu_torch.ops import kernels
from libllsm2_tpu_torch.parallel import corpus
from libllsm2_tpu_torch.utils import testsig
out = {"fp64": fp.FP64}
dev = torch.device("cuda", 0)
draws, noise_bins_ref = [], kernels.noise_bins_ref


def draw(*a, **k):
    re_im = noise_bins_ref(*a, **k)
    draws.append(str(re_im[0].device))
    return re_im


kernels.noise_bins_ref = draw
x, f0 = testsig.make_test_utterance(duration=0.5)
kernels.reset_launches()
c = layer0.analyze(lt.create_aoptions(), x, f0)
o = layer0.synthesize(lt.create_soptions(), c)
out["dtypes"] = sorted({str(getattr(c, k).dtype) for k in
                        ("f0", "ampl", "phse", "hm_mask", "psd", "edc",
                         "eenv_a", "eenv_p")} |
                       {str(getattr(o, k).dtype) for k in ("y", "y_sin")})
out["device"] = str(o.y.device)
y = o.y_sin.cpu().numpy()
n = len(y)
lo, hi = int(0.1 * n), int(0.9 * n)
out["snr"] = float(10 * np.log10(np.sum(x[lo:hi] ** 2)
                                 / np.sum((x[lo:hi] - y[lo:hi]) ** 2)))
torch.cuda.synchronize()
out["launches"] = dict(kernels.LAUNCHES)
refused = 0
for make in (lt.create_aoptions, lt.create_soptions):
    try:
        make(use_pallas=True)
    except ValueError:
        refused += 1
out["refused"] = refused
out["draw_devices"] = sorted(set(draws))
# the draw at a bench row's size on the card against the host's (libm's
# log there, the card's correctly rounded one: an ulp apart at times)
torch.cuda.synchronize()
t0 = time.perf_counter()
card = noise_bins_ref(0x5eed, 0, 1, 1600, 81, dev, dtype=torch.float64)
torch.cuda.synchronize()
out["draw_ms"] = (time.perf_counter() - t0) * 1e3
host = noise_bins_ref(0x5eed, 0, 1, 1600, 81, "cpu", dtype=torch.float64)
g = torch.stack([v[0] for v in card]).cpu().numpy().view(np.int64)
h = torch.stack([v[0] for v in host]).numpy().view(np.int64)
out["draw_n"], out["draw_unequal"] = int(g.size), int((g != h).sum())
out["draw_max_ulp"] = int(np.abs(g - h).max())
data = tuple(d.double() if d.is_floating_point() else d
             for d in cs.fixtures(torch, dev))
opt, sopt = lt.create_aoptions(f0_floor=70.0), lt.create_soptions()
kernels.reset_launches()
yb, snrb, _ = corpus.batched_pipeline(opt, sopt, *data[:2], data[3], data[2])
torch.cuda.synchronize()
out["step_launches"] = dict(kernels.LAUNCHES)
out["step_dtype"] = str(yb.dtype)
out["step_snr01"] = [float(v) for v in snrb[:2].cpu()]
del yb
torch.cuda.reset_peak_memory_stats()
t0 = time.perf_counter()
corpus.batched_pipeline(opt, sopt, *data[:2], data[3], data[2])
torch.cuda.synchronize()
out["step_ms"] = (time.perf_counter() - t0) * 1e3
out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
print(json.dumps(out))
'''


def fp64_phase(torch, plain_ms, plain_peak):
    """18a (cell cli-fp64): a subprocess with LLSM_FP64=1 on the card:
    tests/test_fp64.py's fixture (float64 fields and output, the SNR
    floor and the JAX package's float64 pin, use_pallas refused, no kernel
    launched), then one 128 x 8 s bench step in float64 beside phase
    16a's float32 plain step."""
    import os
    env = dict(os.environ, LLSM_FP64="1")
    repo = str(Path(__file__).resolve().parent)
    r = subprocess.run([sys.executable, "-c", FP64_CHILD, repo], env=env,
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        phase("18a fp64", False, r.stderr[-3000:])
    out = json.loads(r.stdout.strip().splitlines()[-1])
    launched = {k: v for k, v in out["launches"].items() if v}
    phase("18a fp64 round trip", out["fp64"]
          and out["dtypes"] == ["torch.float64"]
          and out["device"].startswith("cuda") and out["snr"] >= 45.0
          and abs(out["snr"] - FP64_SNR_PIN_DB) <= FP64_SNR_TOL_DB
          and out["refused"] == 2 and not launched
          and out["draw_devices"] == [out["device"]],
          f"dtypes {out['dtypes']} on {out['device']}, the noise drawn on "
          f"{out['draw_devices']}; y_sin SNR "
          f"{out['snr']:.4f} dB (>= 45; JAX float64 {FP64_SNR_PIN_DB:.4f} +- "
          f"{FP64_SNR_TOL_DB}); use_pallas refused by {out['refused']} of 2 "
          f"constructors; kernels launched: {launched or 'none'}")
    phase("18a fp64 noise draw on the card", out["draw_max_ulp"] <= 2
          and out["draw_unequal"] <= 1e-4 * out["draw_n"],
          f"1600 frames x 81 bins x (re, im) in {out['draw_ms']:.2f} ms: "
          f"{out['draw_unequal']} of {out['draw_n']} normals differ from "
          f"the host's (JAX's x64 bits) by <= {out['draw_max_ulp']} ulp "
          f"(<= 2 and <= 1e-4 of them)")
    launched = {k: v for k, v in out["step_launches"].items() if v}
    phase("18a fp64 bench step", out["step_dtype"] == "torch.float64"
          and not launched,
          f"{BATCH} x {DURATION} s library default in float64: "
          f"{out['step_ms']:.2f} ms, peak {out['peak_gib']:.2f} GiB "
          f"(phase 16a float32: {plain_ms:.2f} ms, peak {plain_peak:.2f} "
          f"GiB; x{out['step_ms'] / plain_ms:.2f}); noisy rows 0/1 SNR "
          f"{out['step_snr01'][0]:.4f} / {out['step_snr01'][1]:.4f} dB; "
          f"kernels launched: {launched or 'none'}")


def cli_phase(torch, rows8):
    """18b: every command of tests/test_cli.py through
    libllsm2_tpu_torch.cli on the card on a generated WAV, with its checks,
    and `batch` on 8 files cut from the bench rows as phase 11 cuts them
    (rows8: the first 8 files' rows, (x, f0) numpy); and a round trip of
    a 44.1 kHz file, which the CLI resamples (on the card) before its
    analysis."""
    import os
    import tempfile

    import numpy as np

    from libllsm2_tpu_torch import cli
    from libllsm2_tpu_torch.ops import resample
    from libllsm2_tpu_torch.utils import audio, testsig

    def std_of(path, seconds=None):
        y, fs = audio.wavread(path)
        ok = np.isfinite(y).all() and float(np.std(y)) > 1e-3
        if seconds is not None:
            ok = ok and abs(len(y) / fs - seconds) < 0.02
        return ok

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "in.wav")
        x, _ = testsig.make_test_utterance(duration=0.4, seed=3)
        audio.wavwrite(p, x.astype(np.float32), 16000)
        j = lambda name: os.path.join(d, name)
        ms = {}

        def run(args):
            t0 = time.perf_counter()
            cli.main(args)
            torch.cuda.synchronize()
            ms[args[0] + ("" if args[0] not in ms else " 2")] = \
                (time.perf_counter() - t0) * 1e3
        run(["roundtrip", p, j("rt.wav")])
        ok = std_of(j("rt.wav"), 0.4)
        run(["pitch-shift", p, j("ps.wav"), "--ratio", "1.5"])
        ok &= std_of(j("ps.wav"))
        run(["track-f0", p, j("f0.txt")])
        f0 = np.loadtxt(j("f0.txt"))
        v = f0[f0 > 0]
        ok &= len(v) > 0.8 * len(f0) and 100 < np.median(v) < 200
        run(["code", p, j("c.npz")])
        run(["decode", j("c.npz"), j("dec.wav")])
        ok &= std_of(j("dec.wav"))
        run(["code", p, j("cq.npz"), "--bits", "8"])
        with np.load(j("cq.npz")) as z:
            ok &= "__coded__" in z.files and z["codes"].dtype == np.uint8
        run(["decode", j("cq.npz"), j("decq.wav")])
        ok &= std_of(j("decq.wav"))
        x44, _ = testsig.make_test_utterance(duration=0.4, fs=44100.0,
                                             seed=3)
        audio.wavwrite(j("in44.wav"), x44.astype(np.float32), 44100)
        seen, resample_to = [], resample.resample_to

        def spy(t, *a, **k):
            seen.append(t.device.type)
            return resample_to(t, *a, **k)
        resample.resample_to = spy
        try:
            run(["roundtrip", j("in44.wav"), j("rt44.wav")])
        finally:
            resample.resample_to = resample_to
        ok &= std_of(j("rt44.wav"), 0.4) and set(seen) == {"cuda"}
        bdir = j("batchin")
        os.makedirs(bdir)
        paths = testsig.write_test_corpus(bdir, 8, lambda i: rows8[i])
        run(["batch", bdir, j("report.json"), "--batch-size", "8"])
        with open(j("report.json")) as f:
            rep = json.load(f)
        ok &= rep["n_files"] == len(paths) and rep["n_failed"] == 0 \
            and rep["mean_snr_db"] > 15.0
    phase("18b cli", bool(ok),
          "test_cli's commands on the card: " + ", ".join(
              f"{k} {v:.0f} ms" for k, v in ms.items())
          + f" (roundtrip 2: a 44.1 kHz file, resampled on "
          f"{sorted(set(seen))})"
          + f"; batch of {rep['n_files']} bench files: mean SNR "
          f"{rep['mean_snr_db']} dB, {rep['x_realtime']}x realtime")


def _union_us(intervals):
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile_phase(torch, corpus, opt, sopt, data):
    """18c: utils.profiling.device_trace around one phase-5 step: the
    trace holds layer0's five llsm.* ranges; the card's busy share of the
    step = the union of its kernel intervals in the trace over the step's
    wall time unprofiled (CUDA events, the median of 3 steps): the
    profiler's host cost per operation stretches the traced span, not the
    kernels.  The traced span's share is printed beside it."""
    import tempfile

    from libllsm2_tpu_torch.utils import profiling
    x, f0, x_ref, nxv = data
    step = lambda: corpus.batched_pipeline(opt, sopt, x, f0, nxv, x_ref)
    step()
    wall = sorted(once_ms(torch, step) for _ in range(3))[1]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        with profiling.device_trace(d):
            with profiling.named_scope("chip_smoke.step"):
                step()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with open(Path(d) / "trace.json") as f:
            events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    names = {e.get("name") for e in spans}
    scopes = ("llsm.analyze.harmonic", "llsm.analyze.residual",
              "llsm.analyze.noise", "llsm.synth.harmonic", "llsm.synth.noise")
    missing = [s for s in scopes if s not in names]
    host = [e for e in spans if e.get("name") == "chip_smoke.step"]
    kern = [(e["ts"], e["ts"] + e["dur"]) for e in spans
            if e.get("cat") == "kernel"]
    detail = f"trace of {len(spans)} spans, {len(kern)} kernels"
    if host and kern:
        start = host[0]["ts"]
        stop = max(host[0]["ts"] + host[0]["dur"], max(b for _, b in kern))
        busy = _union_us([(max(a, start), min(b, stop)) for a, b in kern
                          if b > start and a < stop])
        share = busy / 1e3 / wall
        detail += (f"; kernels busy {busy / 1e3:.2f} ms of the step's "
                   f"{wall:.2f} ms unprofiled = {share * 100:.2f}%, idle "
                   f"{(1 - share) * 100:.2f}% (the traced span "
                   f"{(stop - start) / 1e3:.2f} ms, {wall_ms:.2f} ms with "
                   f"the profiler on: busy {busy / (stop - start) * 100:.2f}% "
                   f"of it)")
    else:
        detail += "; no kernel events: busy share not measured"
    phase("18c profile", not missing and bool(host),
          f"the five scopes {'present' if not missing else missing}; "
          + detail)


MESH_CHILD = r'''
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
cs.mesh_rank(*sys.argv[2:])
'''


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _digest(np, arrays):
    """sha256 of the arrays' bytes, in order (ranks compare results)."""
    import hashlib
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _chunk_arrays(chunk):
    return {k: getattr(chunk, k).detach().cpu().numpy() for k in MESH_FIELDS}


def _mesh_round_trip(seqparallel, opt, sopt, x, f0, mesh):
    chunk = seqparallel.analyze_frame_sharded(opt, x, f0, mesh)
    return chunk, seqparallel.synthesize_frame_sharded(sopt, chunk, mesh)


def mesh_rank(tmp, rank, world):
    """One rank of phase 19, in a child process (python -c MESH_CHILD REPO
    TMP RANK WORLD): joins the others through a FileStore in TMP on the
    backend distributed.choose_backend picks (gloo: the ranks share one
    card), loads the kernel library phase 2 built, runs 19a-19e on
    TMP's inputs (TMP/cfg.json: device, pool streams, rows), prints its
    lines and writes TMP/rank{RANK}.json (and rank 0 its arrays).  A
    failed check raises: the process exits non-zero."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from libllsm2_tpu_torch import create_aoptions, create_soptions
    from libllsm2_tpu_torch.container import index_batch
    from libllsm2_tpu_torch.models import layer0, neural
    from libllsm2_tpu_torch.ops import _build, kernels
    from libllsm2_tpu_torch.parallel import corpus, distributed, expert
    from libllsm2_tpu_torch.parallel import mesh as ml
    from libllsm2_tpu_torch.parallel import pipeline, seqparallel
    from libllsm2_tpu_torch.runtime import rtsynth
    from libllsm2_tpu_torch.runtime.rtserve import StreamPool
    from libllsm2_tpu_torch.utils import serialize
    t0 = time.perf_counter()
    rank, world = int(rank), int(world)
    with open(f"{tmp}/cfg.json") as f:
        cfg = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = distributed.choose_backend(world)
    distributed.initialize_multihost(f"file://{tmp}/store", world, rank,
                                     timeout_s=600)
    on_card = cfg["device"] == "cuda"
    dev = ml.local_device(None if on_card else "cpu")
    if on_card:
        torch.cuda.set_device(dev)
        _build.library()
    say = lambda msg: print(f"19 rank {rank}: {msg}", flush=True)
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    say(f"{name} {dev}, backend {dist.get_backend()} (rule: {backend} for "
        f"{world} ranks on {torch.cuda.device_count() if on_card else 0} "
        f"card(s)), up in {time.perf_counter() - t0:.1f} s")
    out = {"rank": rank, "device": str(dev), "name": name,
           "backend": dist.get_backend()}
    opt = create_aoptions(f0_floor=70.0, use_pallas=True)
    sopt = dataclasses.replace(create_soptions(), use_pallas=True)

    def timed(fn):
        _sync(torch, dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        res = fn()
        _sync(torch, dev)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card \
            else float("nan")
        return res, (time.perf_counter() - t) * 1e3, peak

    # 19a: the frame-sharded round trip of two long utterances
    mf = ml.make_mesh(world, frame_parallel=world, device=dev)
    z = np.load(f"{tmp}/utts.npz")
    launches = dict.fromkeys(kernels.LAUNCHES, 0)
    out["19a"] = {}
    chunks = {}
    for seed in MESH_SEEDS:
        x, f0 = z[f"x{seed}"], z[f"f0{seed}"]
        kernels.reset_launches()
        mf.reset_counts()
        calls, (chunk, res) = capture_kernel_inputs(
            kernels, PATH, lambda: _mesh_round_trip(seqparallel, opt, sopt,
                                                    x, f0, mf))
        _sync(torch, dev)
        for k, v in kernels.LAUNCHES.items():
            launches[k] += v
        rec = {"moved": dict(mf.moved), "staged": mf.staged,
               "launches": {k: v for k, v in kernels.LAUNCHES.items() if v}}
        missing = [k for k in PATH if not calls[k]]
        phase(f"19a rank {rank} seed {seed} kernels", not missing,
              f"every wrapper of the path called (missing: {missing}); "
              f"launches {rec['launches']}")
        if on_card:
            for k in PATH:
                home = "denoise_apply" if k == FINISH else k
                for i, (args, kw) in enumerate(calls[k]):
                    check_kernel(torch, kernels, k, KERNELS[home][2], args,
                                 kw, f"rank {rank} seed {seed} call {i}",
                                 prefix="19a", reps=cfg["reps"])
        del calls
        # timed runs, each stage alone (a second run: the first one above
        # paid the first-call costs), and the same result again
        c2, rec["analysis_ms"], rec["analysis_peak_gib"] = timed(
            lambda: seqparallel.analyze_frame_sharded(opt, x, f0, mf))
        r2, rec["synthesis_ms"], rec["synthesis_peak_gib"] = timed(
            lambda: seqparallel.synthesize_frame_sharded(sopt, c2, mf))
        arrays = _chunk_arrays(chunk)
        ys = {k: getattr(res, k).cpu().numpy() for k in ("y", "y_sin",
                                                          "y_nos")}
        again = list(_chunk_arrays(c2).values()) + [r2.y.cpu().numpy()]
        rec["digest"] = _digest(np, list(arrays.values()) + [ys["y"]])
        phase(f"19a rank {rank} seed {seed} repeat", _digest(np, again)
              == rec["digest"], "a second run gives the same chunk and y")
        if rank == 0:
            np.savez(f"{tmp}/chunk{seed}.npz", **arrays, **ys)
        out["19a"][str(seed)] = rec
        chunks[seed] = chunk
        say(f"19a seed {seed}: {len(f0)} frames, {len(f0) // world} a rank: "
            f"analysis {rec['analysis_ms']:.2f} ms (peak "
            f"{rec['analysis_peak_gib']:.3f} GiB), synthesis "
            f"{rec['synthesis_ms']:.2f} ms (peak "
            f"{rec['synthesis_peak_gib']:.3f} GiB); moved {rec['moved']} B, "
            f"staged through the host {rec['staged']} B")
    out["launches"] = launches
    say(f"19a launches (both seeds): "
        f"{ {k: v for k, v in launches.items() if v} }")

    # 19b: the data-parallel corpus step on the bench rows
    m = ml.make_mesh(world, device=dev)
    bx, bf0, bref = (np.load(f"{tmp}/bench_{k}.npy", mmap_mode="r")
                     for k in ("x", "f0", "ref"))
    per = bx.shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    xs, f0s, xr = (torch.from_numpy(np.ascontiguousarray(a[rows])).to(dev)
                   for a in (bx, bf0, bref))
    nxv = torch.full((per,), bx.shape[1], dtype=torch.int64, device=dev)
    step = lambda: corpus.batched_pipeline(opt, sopt, xs, f0s, nxv, xr,
                                           mesh=m)
    kernels.reset_launches()
    m.reset_counts()
    (y, snr, mean), _, peak = timed(step)
    rec = {"launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
           "moved": dict(m.moved), "snr": snr.cpu().numpy().tolist(),
           "mean": float(mean), "peak_gib": peak}
    np.save(f"{tmp}/bp_y{rank}.npy", y.cpu().numpy())
    rec["step_ms"] = statistics.median(timed(step)[1] for _ in range(3))
    out["19b"] = rec
    say(f"19b: {per} of {bx.shape[0]} rows x {bx.shape[1]} samples: step "
        f"{rec['step_ms']:.2f} ms (median of 3), peak {peak:.3f} GiB; "
        f"gathers moved {rec['moved']} B")

    # 19c: the pool, its streams' rows rendered by their ranks
    pr = list(range(cfg["pool_streams"] // 2)) + list(
        range(bx.shape[0] // 2, bx.shape[0] // 2 + cfg["pool_streams"] // 2))
    chunk = layer0._analyze(opt, *(torch.from_numpy(
        np.ascontiguousarray(a[pr])).to(dev) for a in (bx, bf0)))
    streams = [index_batch(chunk, s) for s in range(len(pr))]
    frames = [rtsynth.RTSynthesizer.chunk_frames_np(c) for c in streams]
    pool = StreamPool(sopt, opt.conf, n_streams=len(pr),
                      feed_block=POOL_BLOCK, mesh=m)
    timings = []
    ys, per_tick, ticks = drain_pool(pool, frames, timings)
    mine = range(rank * len(pr) // world, (rank + 1) * len(pr) // world)
    bad = []
    for s in mine:
        so = dataclasses.replace(sopt, noise_seed=sopt.noise_seed + s)
        if not np.array_equal(ys[s], rtsynth.stream_chunk(
                so, streams[s], block=POOL_BLOCK)):
            bad.append(s)
    phase(f"19c rank {rank} streams = solo", not bad,
          f"streams {mine.start}-{mine.stop - 1} (this rank's) bit for bit "
          f"against stream_chunk(block={POOL_BLOCK}); unequal: {bad}")
    tot = [sum(t.values()) for t in timings]
    out["19c"] = {"digest": _digest(np, ys), "ticks": ticks,
                  "tick_ms": statistics.median(tot),
                  "render_ms": statistics.median(t["render"]
                                                 for t in timings)}
    say(f"19c: {len(pr)} streams x {POOL_BLOCK} hops, {ticks} ticks: "
        f"{out['19c']['tick_ms']:.2f} ms a tick (median; render and gather "
        f"{out['19c']['render_ms']:.2f})")
    del chunk, streams, frames, pool, xs, f0s, xr

    # 19d: model parallelism at the default widths on the coder vectors
    v = np.load(f"{tmp}/vectors.npy", mmap_mode="r")
    D = v.shape[1]
    gen = lambda s: torch.Generator().manual_seed(s)
    steps = MESH_TRAIN_STEPS
    rec = {}
    ae = neural.AEConfig(dims=D, lr=AE_LR)
    params = neural.init_params(ae, gen(0), device=dev)
    opt_s = neural.make_optimizer(ae, params)
    xb = ml.shard_rows(v, m)
    rec["dp"] = _train_steps(torch, lambda: neural.train_step(
        ae, params, opt_s, xb, mesh=m)[2], steps)
    tm = ml.make_tp_mesh(world, model_parallel=2, device=dev)
    params = neural.shard_params_tp(ae, neural.init_params(ae, gen(0), dev),
                                    tm)
    opt_s = neural.make_optimizer(ae, params)
    xb = ml.shard_batch(v, tm)
    rec["tp"] = _train_steps(torch, lambda: neural.train_step(
        ae, params, opt_s, xb, mesh=tm)[2], steps)
    trunk = pipeline.TrunkConfig(dims=D)
    pm = ml.make_pipe_mesh(world, device=dev)
    ps = pipeline.shard_params_pp(pipeline.init_trunk_params(
        trunk, gen(1), device=dev), pm)
    xb = torch.from_numpy(np.ascontiguousarray(v[:cfg["pp_rows"]])).to(dev)
    fwd = pipeline.pp_forward(trunk, ps, xb, pm).detach().cpu().numpy()
    opt_s = pipeline.make_optimizer(trunk, ps)
    rec["pp"] = _train_steps(torch, lambda: pipeline.train_step_pp(
        trunk, ps, opt_s, xb, pm)[2], steps)
    moe = expert.MoEConfig(dims=D)
    em = ml.make_expert_mesh(world, device=dev)
    es = expert.shard_params_ep(moe, expert.init_moe_params(
        moe, gen(2), device=dev), em)
    xb = ml.shard_rows(v[:cfg["ep_rows"]], em, ml.EXPERT_AXIS)
    y, aux = expert.moe_forward_ep(moe, es, xb, em, capacity=xb.shape[0])
    ep_fwd = ml.all_gather(y.detach(), em, ml.EXPERT_AXIS).cpu().numpy()
    opt_s = expert.make_optimizer(moe, es)
    rec["ep"] = _train_steps(torch, lambda: expert.train_step_ep(
        moe, es, opt_s, xb, em)[2], steps)
    rec["ep_aux"] = float(aux)
    if rank == 0:
        np.savez(f"{tmp}/models.npz", pp_fwd=fwd, ep_fwd=ep_fwd)
    out["19d"] = rec
    say("19d: ms a step (median of {}): DP AE {:.3f}, TP AE {:.3f}, PP "
        "trunk {:.3f}, EP MoE {:.3f}".format(
            steps, *(rec[k][1] for k in ("dp", "tp", "pp", "ep"))))

    # 19e: the clean chunk of 19a, saved by every rank (its frame rows)
    (_, ck_ms, _) = timed(lambda: serialize.chunk_save_orbax(
        f"{tmp}/ckpt", chunks[list(MESH_SEEDS)[-1]], mesh=mf))
    out["19e_ms"] = ck_ms

    # which collectives gloo ran on the CUDA tensors itself (the meshes
    # stage through the host those it refuses)
    out["gloo_cuda"] = {op: ("runs on CUDA tensors" if v else
                             "refused: staged through the host")
                        for g in (mf, m, tm, pm, em)
                        for op, v in g.gloo_cuda.items()}
    dist.barrier()
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def mesh_phase(torch, mods, data, vec, dev):
    """Phase 19 (cell multi-device): 4 ranks as child processes on the one
    card (mesh_rank), then the checks of their results here against this
    process's one-process runs on the card -> the ranks' kernel launches of
    19a, summed."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from libllsm2_tpu_torch import create_aoptions, create_soptions
    from libllsm2_tpu_torch.models import layer0, neural
    from libllsm2_tpu_torch.parallel import (corpus, expert, pipeline,
                                             seqparallel)
    from libllsm2_tpu_torch.utils import serialize, testsig
    layer0, = mods
    opt = create_aoptions(f0_floor=70.0, use_pallas=True)
    sopt = dataclasses.replace(create_soptions(), use_pallas=True)
    on_card = dev.type == "cuda"
    tmp = tempfile.mkdtemp(prefix="llsm_mesh_")
    try:
        t0 = time.perf_counter()
        # the harmonic part, the same for both seeds, synthesized once
        rows = testsig.make_test_utterances(list(MESH_SEEDS.items()),
                                            duration=MESH_SECONDS)
        utts = {seed: [np.asarray(a, np.float32) for a in r]
                for seed, r in zip(MESH_SEEDS, rows)}
        np.savez(f"{tmp}/utts.npz", **{f"{k}{seed}": a for seed, u in
                                       utts.items()
                                       for k, a in zip(("x", "f0"), u)})
        for k, a in zip(("x", "f0", "ref"), (data[0], data[1], data[2])):
            np.save(f"{tmp}/bench_{k}.npy", a.cpu().numpy())
        B, N, D = vec.shape
        flat = vec.reshape(-1, D).cpu().numpy()
        vn = neural.Normalizer(flat).fwd(flat).astype(np.float32)
        np.save(f"{tmp}/vectors.npy", vn)
        cfg = dict(device=dev.type, reps=MESH_REPS,
                   pool_streams=min(POOL_STREAMS, data[0].shape[0]),
                   pp_rows=MESH_PP_ROWS, ep_rows=MESH_EP_ROWS)
        with open(f"{tmp}/cfg.json", "w") as f:
            json.dump(cfg, f)
        repo = str(Path(__file__).resolve().parent)
        t1 = time.perf_counter()
        procs = []
        for r in range(MESH_RANKS):
            log = open(f"{tmp}/out{r}.txt", "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", MESH_CHILD, repo, tmp, str(r),
                 str(MESH_RANKS)], stdout=log, stderr=subprocess.STDOUT),
                log))
        deadline = time.monotonic() + MESH_TIMEOUT_S
        rcs = []
        for p, log in procs:
            try:
                rcs.append(p.wait(timeout=max(deadline - time.monotonic(),
                                              1.0)))
            except subprocess.TimeoutExpired:
                rcs.append(None)
            log.close()
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        ranks_s = time.perf_counter() - t1
        for r in range(MESH_RANKS):
            with open(f"{tmp}/out{r}.txt") as f:
                text = f.read()
            if rcs[r] == 0:
                print(text, end="", flush=True)
            else:
                print(f"19 rank {r} exited {rcs[r]}:\n{text[-6000:]}",
                      flush=True)
        phase("19 ranks", all(rc == 0 for rc in rcs),
              f"{MESH_RANKS} ranks exited {rcs} after {ranks_s:.1f} s "
              f"(inputs written in {t1 - t0:.1f} s)")
        res = []
        for r in range(MESH_RANKS):
            with open(f"{tmp}/rank{r}.json") as f:
                res.append(json.load(f))
        phase("19 ranks on the card", all(
            o["device"].startswith(dev.type) for o in res),
              f"devices {[o['device'] for o in res]} ({res[0]['name']}), "
              f"backend {[o['backend'] for o in res]}; gloo's collectives "
              f"on CUDA tensors: {res[0]['gloo_cuda'] or 'none (CPU)'}")

        # 19a against this process's runs of the same utterances: the
        # whole analysis (F0 and with it the tracks are one process's bits),
        # then every stage after the F0 refinement fed the sharded run's F0
        edge = MESH_EDGE
        inner = slice(edge, -edge)
        cz = lambda a, p: a * np.exp(1j * p.astype(np.float64))
        no_refine = dataclasses.replace(opt, f0_refine=False)
        for seed, (x, f0, x_ref) in utts.items():
            nl = len(f0) // MESH_RANKS
            ha = seqparallel._halos(opt, nl)[0]
            got = np.load(f"{tmp}/chunk{seed}.npz")
            phase(f"19a seed {seed} ranks agree", len({
                o["19a"][str(seed)]["digest"] for o in res}) == 1,
                  "every rank returned the same chunk and y")
            ref = layer0.analyze(opt, x, f0, device=dev)
            out_ref = layer0.synthesize(sopt, ref)
            r = _chunk_arrays(ref)
            f0_rel = np.abs(got["f0"] - r["f0"]) / np.maximum(
                np.abs(r["f0"]), 1e-6)
            rows = np.nonzero(f0_rel)[0]
            f0_eq = np.array_equal(got["f0"], r["f0"])
            ampl_eq = np.array_equal(got["ampl"], r["ampl"])
            ampl_rows = np.nonzero((got["ampl"] != r["ampl"]).any(-1))[0]
            ref_t = torch.tensor(x_ref, device=dev)
            snr = snr_db(torch, ref_t, torch.tensor(got["y_sin"], device=dev),
                         opt.conf.fs, opt.conf.f0_floor)
            snr1 = snr_db(torch, ref_t, out_ref.y_sin, opt.conf.fs,
                          opt.conf.f0_floor)
            pin = MESH_PINS_DB[seed] if MESH_SECONDS == MESH_PINS_SECONDS \
                else None
            whole = {"ampl": np.abs(got["ampl"] - r["ampl"]).max(),
                     "cplx": np.abs(cz(got["ampl"], got["phse"])
                                    - cz(r["ampl"], r["phse"])).max(),
                     "psd": np.abs(got["psd"] - r["psd"]).max()}
            mask_eq = np.array_equal(got["hm_mask"], r["hm_mask"])
            phase(f"19a seed {seed} against one process", mask_eq
                  and f0_eq and ampl_eq and whole["cplx"] == 0
                  and whole["psd"] == 0
                  and abs(snr - snr1) <= MESH_SNR_TOL_DB
                  and (pin is None or (abs(snr - pin[1]) <= MESH_SNR_TOL_DB
                                       and snr >= pin[0] - MESH_SNR_TOL_DB)),
                  f"hm_mask equal {mask_eq}; f0 equal (bit for bit) {f0_eq}:"
                  f" largest relative difference {f0_rel.max():.3e} in "
                  f"{len(rows)} of {len(f0_rel)} rows (a {nl + 2 * ha}-"
                  f"frame block's refine against the whole track's); ampl "
                  f"equal {ampl_eq} (max |difference| {whole['ampl']:.3e} "
                  f"in {len(ampl_rows)} rows {ampl_rows[:8].tolist()}"
                  f"{'...' if len(ampl_rows) > 8 else ''}),"
                  f" complex {whole['cplx']:.3e}, psd {whole['psd']:.3e}; "
                  f"y_sin SNR "
                  f"sharded {snr:.4f} dB, one process {snr1:.4f} dB (+- "
                  f"{MESH_SNR_TOL_DB}); JAX one process, sharded (the "
                  f"floor, - {MESH_SNR_TOL_DB}): "
                  + ("n/a" if pin is None else
                     f"{pin[1]:.4f}, {pin[0]:.4f}"))
            # every stage after the refinement, fed the sharded F0
            ref = _chunk_arrays(layer0.analyze(no_refine, x, got["f0"],
                                               device=dev))
            errs = {
                "ampl": np.abs(got["ampl"] - ref["ampl"])[inner].max(),
                "cplx": np.abs(cz(got["ampl"], got["phse"])
                               - cz(ref["ampl"], ref["phse"]))[inner].max(),
                "psd": np.abs(got["psd"] - ref["psd"])[inner].max(),
                "edc": np.abs(got["edc"] - ref["edc"]).max(),
                "env": np.abs(cz(got["eenv_a"], got["eenv_p"])
                              - cz(ref["eenv_a"], ref["eenv_p"])).max(),
                "env_inner": np.abs(cz(got["eenv_a"], got["eenv_p"])
                                    - cz(ref["eenv_a"], ref["eenv_p"]))
                [4:-4].max()}
            # the render of the sharded chunk, here in one process
            chunk = layer0.Chunk(**{k: torch.tensor(got[k], device=dev)
                                    for k in MESH_FIELDS}, conf=opt.conf)
            one = layer0.synthesize(sopt, chunk)
            errs["y_sin"] = float(np.abs(got["y_sin"]
                                         - one.y_sin.cpu().numpy()).max())
            errs["y"] = float(np.abs(got["y"] - one.y.cpu().numpy()).max())
            phase(f"19a seed {seed} stages after the refinement", all(
                errs[k] <= MESH_TOL[k] for k in MESH_TOL) and np.array_equal(
                    got["hm_mask"], ref["hm_mask"]),
                  "against one process fed the sharded F0 (f0_refine off; "
                  f"ampl, complex, psd on rows [{edge}:-{edge}], the render "
                  "of the sharded chunk): " + ", ".join(
                      f"{k} {errs[k]:.3e} (<= {MESH_TOL[k]})"
                      for k in MESH_TOL))
            recs = [o["19a"][str(seed)] for o in res]
            print(f"19a seed {seed} ranks: analysis ms "
                  f"{[round(q['analysis_ms'], 2) for q in recs]}, synthesis "
                  f"ms {[round(q['synthesis_ms'], 2) for q in recs]}, peaks "
                  f"GiB {[round(q['analysis_peak_gib'], 3) for q in recs]} / "
                  f"{[round(q['synthesis_peak_gib'], 3) for q in recs]}; "
                  f"bytes moved a rank {[sum(q['moved'].values()) for q in recs]}"
                  f" (staged {[q['staged'] for q in recs]})", flush=True)
            del ref, out_ref, chunk, one
        launches = {k: sum(o["launches"][k] for o in res)
                    for k in res[0]["launches"]}
        # (the wrappers count launches of the card's kernels only)
        missing = [k for k in PATH if on_card
                   and not all(o["launches"][k] for o in res)]
        phase("19a launches", not missing,
              f"every rank launched every kernel of the path (missing: "
              f"{missing}); summed over ranks: "
              f"{ {k: v for k, v in launches.items() if v} }")

        # 19b against this process's 128-row batch
        y, snr, mean = corpus.batched_pipeline(opt, sopt, *data[:2], data[3],
                                               data[2])
        y, snr = y.cpu().numpy(), snr.cpu().numpy()
        per = y.shape[0] // MESH_RANKS
        rows_eq = all(np.array_equal(
            np.load(f"{tmp}/bp_y{r}.npy"), y[r * per:(r + 1) * per])
            for r in range(MESH_RANKS))
        snr_eq = all(np.array_equal(np.asarray(o["19b"]["snr"], np.float32),
                                    snr) for o in res)
        means = [o["19b"]["mean"] for o in res]
        step1 = statistics.median(
            once_ms(torch, lambda: corpus.batched_pipeline(
                opt, sopt, *data[:2], data[3], data[2])) if on_card else 0.0
            for _ in range(3))
        phase("19b data-parallel corpus", rows_eq and snr_eq and all(
            abs(m_ - float(mean)) <= MESH_MEAN_TOL_DB for m_ in means),
              f"{MESH_RANKS} x {per} rows: every rank's y rows and the "
              f"gathered snr bit for bit the one-process batch's ({rows_eq},"
              f" {snr_eq}); mean_snr {means[0]:.6f} dB (one process "
              f"{float(mean):.6f} +- {MESH_MEAN_TOL_DB}); step ms a rank "
              f"{[round(o['19b']['step_ms'], 2) for o in res]} (one process,"
              f" {y.shape[0]} rows: {step1:.2f}); gathers "
              f"{res[0]['19b']['moved']} B a rank; launches "
              f"{res[0]['19b']['launches']}")
        del y

        # 19c: every rank holds every stream alike
        phase("19c pool", len({o["19c"]["digest"] for o in res}) == 1,
              f"{cfg['pool_streams']} streams over {MESH_RANKS} ranks: every "
              f"rank's every stream the same (each rank held its own "
              f"streams to their solo renders); {res[0]['19c']['ticks']} "
              f"ticks, ms a tick {[round(o['19c']['tick_ms'], 2) for o in res]}"
              f" (render and gather "
              f"{[round(o['19c']['render_ms'], 2) for o in res]})")

        # 19d against this process's runs
        flat = torch.tensor(vn, device=dev)
        gen = lambda s: torch.Generator().manual_seed(s)
        ae = neural.AEConfig(dims=D, lr=AE_LR)
        params = neural.init_params(ae, gen(0), device=dev)
        opt_s = neural.make_optimizer(ae, params)
        ref_ae, ae_ms = _train_steps(torch, lambda: neural.train_step(
            ae, params, opt_s, flat)[2], MESH_TRAIN_STEPS)
        trunk = pipeline.TrunkConfig(dims=D)
        tp = pipeline.init_trunk_params(trunk, gen(1), device=dev)
        xb = flat[:MESH_PP_ROWS]
        fwd = pipeline.forward_reference(trunk, tp, xb).detach().cpu().numpy()
        opt_s = pipeline.make_optimizer(trunk, tp)
        ref_pp, pp_ms = _train_steps(torch, lambda: neural.optimizer_step(
            opt_s, lambda: torch.mean((pipeline.forward_reference(
                trunk, tp, xb) - xb) ** 2)).detach(), MESH_TRAIN_STEPS)
        moe = expert.MoEConfig(dims=D)
        mp_ = expert.init_moe_params(moe, gen(2), device=dev)
        with torch.no_grad():
            ep_ref = expert.moe_forward_reference(
                moe, mp_, flat[:MESH_EP_ROWS], MESH_EP_ROWS).cpu().numpy()
        got = np.load(f"{tmp}/models.npz")
        d = res[0]["19d"]
        close = lambda a, b, rtol: bool(np.allclose(a, b, rtol=rtol, atol=0))
        # test_pp_ep.py's tolerance: rtol and atol MESH_FWD_TOL
        fwd_err = float(np.max(np.abs(got["pp_fwd"] - fwd)
                               / (1.0 + np.abs(fwd))))
        ep_err = float(np.max(np.abs(got["ep_fwd"] - ep_ref)
                              / (1.0 + np.abs(ep_ref))))
        phase("19d model parallelism", close(d["tp"][0], d["dp"][0],
                                             MESH_LOSS_RTOL)
              and close(d["dp"][0], ref_ae, MESH_LOSS_RTOL)
              and fwd_err <= MESH_FWD_TOL and close(d["pp"][0], ref_pp,
                                                    MESH_PP_RTOL)
              and ep_err <= MESH_FWD_TOL and all(
                  o["19d"]["dp"][0] == d["dp"][0] for o in res),
              f"AE (hidden {ae.hidden}) 5-step losses TP (batch 2, model 2) "
              f"{[round(q, 5) for q in d['tp'][0]]}, DP (4) "
              f"{[round(q, 5) for q in d['dp'][0]]}, one process "
              f"{[round(q, 5) for q in ref_ae]} (rtol {MESH_LOSS_RTOL}); "
              f"trunk (hidden {trunk.hidden}, {trunk.n_blocks} blocks, 4 "
              f"stages) forward max err {fwd_err:.2e} (of 1 + |ref|; <= "
              f"{MESH_FWD_TOL}), "
              f"losses {[round(q, 6) for q in d['pp'][0]]} vs "
              f"{[round(q, 6) for q in ref_pp]} (rtol {MESH_PP_RTOL}); MoE "
              f"({moe.n_experts} experts over 4 ranks) forward max err "
              f"{ep_err:.2e} (of 1 + |ref|), aux {d['ep_aux']:.4f}; ms a "
              f"step: DP "
              f"{d['dp'][1]:.3f}, TP {d['tp'][1]:.3f}, PP {d['pp'][1]:.3f}, "
              f"EP {d['ep'][1]:.3f}; one process: AE {ae_ms:.3f}, trunk "
              f"{pp_ms:.3f}")
        del flat, params, tp, mp_

        # 19e: the checkpoint written by the ranks, loaded here
        back = serialize.chunk_load_orbax(f"{tmp}/ckpt", device=dev)
        got = np.load(f"{tmp}/chunk{list(MESH_SEEDS)[-1]}.npz")
        same = all(np.array_equal(getattr(back, k).cpu().numpy(), got[k])
                   for k in MESH_FIELDS) and back.conf == opt.conf
        phase("19e checkpoint", same,
              f"the {back.nfrm}-frame chunk written by {MESH_RANKS} ranks "
              f"(torch.distributed.checkpoint, each its frame rows, ms "
              f"{[round(o['19e_ms'], 1) for o in res]}) loaded by one "
              f"process: every field and the conf equal")
        print(f"19: {time.perf_counter() - t0:.1f} s", flush=True)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def wide_cases(torch, kernels, calls, prefix):
    """Each captured call of each kernel against its plain version, as
    phase 3 holds them (the finish under denoise_apply) -> {kernel:
    [case]}."""
    out = {}
    for name, recs in calls.items():
        home = "denoise_apply" if name == FINISH else name
        for i, (args, kw) in enumerate(recs):
            out.setdefault(home, []).append(check_kernel(
                torch, kernels, name, KERNELS[home][2], args, kw,
                f"{name} {i}" if name == FINISH else str(i), prefix=prefix))
    return out


def wide_path(torch, mods, label, opt, sopt, data, pins,
              checked=FULL_CHECKED, extra=(), rows=(0, N_NOISY)):
    """Phase 20a / 20b / 20e / 20g: the path's kernels (the main six, the
    finish and `extra`) against their twins on its calls at 2 rows, then
    the counted run at full batch (run_path: launches, pins, full-batch
    times beside the bounds, those in `checked` against their twins, the
    step) and `rows` alone -> (cases, launches, full-batch records, by
    kernel each 2-row call's tensor arguments' shapes)."""
    kernels, layer0, corpus = mods
    names = MAIN_SIX + (FINISH,) + tuple(extra)
    two = tuple(d[:2] for d in data)
    calls, _ = capture_kernel_inputs(
        kernels, names, lambda: corpus.batched_pipeline(opt, sopt, *(
            two[i] for i in (0, 1, 3, 2))))
    for name in names:
        if not calls[name]:
            phase(f"{label} {name}", False, "not called at 2 rows")
    shapes = {name: [[tuple(a.shape) for a in c[0] if torch.is_tensor(a)]
                     for c in calls[name]] for name in names}
    cases = wide_cases(torch, kernels, calls, label.split()[0])
    del calls
    launches, snr, full = run_path(torch, kernels, corpus, label, opt, sopt,
                                   data, pins, names, names, clean_min=None,
                                   noisy_tol=L0_NOISY_TOL_DB, checked=checked)
    batch_rows(torch, mods, opt, sopt, data, snr, rows=rows,
               label=label.split()[0])
    torch.cuda.empty_cache()
    return cases, launches, full, shapes


def wide_viterbi(torch, kernels, f0mod, x):
    """Phase 20d: viterbi_scan against its twin past 256 states, then the
    tracker at each of WIDE_TRACKER_NBINS on bench rows x -> (cases, the
    tracker runs' launches)."""
    dev = x.device
    g = torch.Generator(device=dev).manual_seed(20)
    cases = []
    for S, renorm in WIDE_STATES + WIDE_STREAM_STATES:
        obs = torch.round(torch.rand((WIDE_VITERBI_ROWS, 1600, S),
                                     generator=g, device=dev) * -96.0) / 8.0
        obs[torch.rand(obs.shape, generator=g, device=dev) < 0.1] = \
            -float("inf")
        obs[..., 0] = -1.0          # no frame all -inf
        lt = f0mod._tables(f0mod.F0Config(nbins=S - 1), dev)["lt"]
        geo = kernels._viterbi_geometry(1600, S)
        runs = (("", obs), (" row 0", obs[:1]))
        if (S, renorm) in WIDE_STATES:
            runs += ((" rows 0-1 joined (3200 frames)",
                      obs[:2].reshape(1, 3200, S)),)
        for label, o in runs:
            case = check_kernel(torch, kernels, VITERBI, KERNELS[VITERBI][2],
                                (o, lt, renorm), {"scores": True},
                                f"S {S}{label}", prefix="20d", reps=3)
            case["geometry"] = list(geo)
            if geo[3] == 5:
                case["geometry"].append(list(kernels._viterbi_stream(
                    o.shape[0], S, kernels._sm_count(dev))))
                phase(f"20d S {S}{label} stream kernel",
                      case["max_abs_err"] == 0.0,
                      f"[{o.shape[0]}, {o.shape[1]}, {S}] {case['ms']:.4f} "
                      f"ms against its bound {case['bound_ms']:.4f} ms "
                      f"({case['bound_by']}): "
                      f"{case['ms'] / case['bound_ms']:.2f}x; grid (warps, "
                      f"dest warps, row warps, rows a thread, slices, row "
                      f"blocks, chunk, bytes) {case['geometry'][-1]}; twin "
                      f"{case['plain_ms']:.1f} ms")
            cases.append(case)
        del obs, lt
        torch.cuda.empty_cache()
    launches = {}
    for nbins in WIDE_TRACKER_NBINS:
        cfg = f0mod.F0Config(fs=16000.0, nhop=80, f0_floor=70.0, nbins=nbins)
        kernels.reset_launches()
        calls, f0 = capture_kernel_inputs(
            kernels, (VITERBI,), lambda: f0mod.track_batch(cfg, x))
        torch.cuda.synchronize()
        got = dict(kernels.LAUNCHES)
        S = calls[VITERBI][0][0][0].shape[-1]
        phase(f"20d tracker nbins {nbins}",
              got[VITERBI] == len(calls[VITERBI]) == 1 and S == nbins + 1
              and bool(torch.isfinite(f0).all() and (f0 >= 0).all()),
              f"f0 {tuple(f0.shape)} finite, "
              f"{float((f0 > 0).float().mean()):.4f} voiced; "
              f"{got[VITERBI]} viterbi_scan launch(es) at S {S}, lt mode "
              f"{kernels._viterbi_geometry(f0.shape[-1], S)[3]}")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        args, kw = calls[VITERBI][0]
        cases.append(check_kernel(torch, kernels, VITERBI,
                                  KERNELS[VITERBI][2], args,
                                  dict(kw, scores=True),
                                  f"tracker nbins {nbins}", prefix="20d",
                                  reps=3))
        del calls, f0, args
        torch.cuda.empty_cache()
    return cases, launches


def fullband_phase(torch, mods, data, join, by_phase):
    """Phase 20e (cell wide, full band): wide_path at each of FULLBAND's
    configurations, 48 kHz at the 5 ms hop (K = 600; the bench rows
    resampled on the card, every F0 frame) and 16 kHz at a 2 ms hop (K =
    200, D = 26; the bench rows made at that hop), where deconv_full and
    denoise_stats run their wide paths (each held to its twin and timed
    beside its bound at full batch); every other kernel's cases and
    full-batch records joined (join: the denoiser's as its wide path's),
    the counted runs' launches by_phase -> (the wide deconvolution's
    cases, its full-batch records)."""
    from libllsm2_tpu_torch import create_aoptions, create_soptions
    from libllsm2_tpu_torch.ops import resample
    kernels = mods[0]
    dev = data[0].device
    cases_w, full_w = [], []
    redesigned = ("deconv_full", "denoise_stats", "denoise_apply")
    for label, (kw, thop) in FULLBAND.items():
        opt = create_aoptions(use_pallas=True, **kw)
        sopt = dataclasses.replace(create_soptions(fs=opt.conf.fs),
                                   use_pallas=True)
        if opt.conf.fs == 16000.0:
            d = fixtures(torch, dev, thop=thop)
        else:
            x, f0, x_ref, nxv = data
            x48, ref48 = (resample.resample_to(v, 16000.0, opt.conf.fs)
                          for v in (x, x_ref))
            d = (x48, f0, ref48, torch.full_like(nxv, x48.shape[-1]))
            del x48, ref48
        conf = opt.conf
        D = -(-conf.halfwin_max // conf.nhop) + 1   # layer0._deconv_correction
        nq = 2 * conf.nhop // min(8, conf.nhop)
        first = kernels._deconv_smem(D, conf.maxnhar, nq)
        geo = kernels._deconv_geometry(D, conf.maxnhar, nq)
        phase(f"20e {label} deconv_full wide",
              first > kernels._SMEM_MAX and geo is not None and geo[1] > 0,
              f"K {conf.maxnhar}, D {D}, nq {nq}: the first kernel's block "
              f"{first} B > {kernels._SMEM_MAX}; the wide path's (frames a "
              f"block, columns a chunk, chunks, bytes, frames a tap-build "
              f"block, field staged) {geo}")
        cases, by_phase[f"20e {label}"], f, shapes = wide_path(
            torch, mods, f"20e {label}", opt, sopt, d,
            FULLBAND_PINS_DB[label], checked=FULL_CHECKED + redesigned)
        ks = [sh[0][-1] for sh in shapes["deconv_full"]]
        phase(f"20e {label} K", ks and all(k == conf.maxnhar for k in ks),
              f"K of deconv_full's calls at 2 rows {ks}")
        # the three wide paths redesigned for the card, at full batch
        K, rows = conf.maxnhar, BATCH * d[1].shape[-1]
        redesigned_lines(f"20e {label}", f, {
            "deconv_full": "", "denoise_stats": "",
            "denoise_apply": "geometry (warps, blocks, pairs a warp, "
            f"stage, bytes) "
            f"{kernels._apply_geometry(K, rows, kernels._sm_count(dev))}"})
        cases_w += cases.pop("deconv_full")
        full_w += f.pop("deconv_full")
        join(cases, f)
        del d
        torch.cuda.empty_cache()
    return cases_w, full_w


def redesigned_lines(label, full, geometry):
    """A phase line for each full-batch record of the kernels in
    `geometry` ({name: its launch's geometry, or ""}), whose wide paths
    were redesigned for the card: its time beside its bound and the
    ratio, its plain version's max error at full batch."""
    for name, geo in geometry.items():
        for rec in full[name]:
            phase(f"{label} {name} wide at full batch",
                  rec["max_abs_err"] is not None and rec["bound_ms"] > 0,
                  f"shapes {rec['shapes']}{', ' + geo if geo else ''}: "
                  f"{rec['ms']:.4f} ms (run {rec['run_ms']:.4f}) against "
                  f"its bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}):"
                  f" {rec['ms'] / rec['bound_ms']:.2f}x; its plain version: "
                  f"max err {rec['max_abs_err']:.3e}")


def wide_shapes(torch, kernels, dev):
    """Phase 20f: the wide kernels that no counted run of phase 20 takes,
    at full batch against their twins (each timed beside its bound):
    env_render past Ke = 8 (Ke 9 at 16 kHz, Ke 12 with 3 channels at 48
    kHz / 10 ms), the cycle track past a 512-sample hop (48 kHz at 20 ms,
    hop 960, and hop 2048) and noise_mod_ola_seg at 9 channels of 9
    envelope harmonics -> {kernel: [case]}."""
    g = torch.Generator(device=dev).manual_seed(22)
    r = lambda *shape: torch.rand(shape, generator=g, device=dev)
    B = BATCH

    def envelope(N, nhop, C, Ke):
        cyc = torch.remainder(torch.cumsum(r(B, N * nhop) * 0.02, -1), 1.0)
        return (cyc, r(B, N, C), (r(B, N, C, Ke) - 0.5) * 0.3,
                (r(B, N, C, Ke) - 0.5) * 0.3, 0.5 + r(B, N, C))

    out = {"env_render": [], "sample_cycles": [], "noise_mod_ola_seg": []}
    for N, nhop, C, Ke in ((1600, 80, 4, 9), (800, 480, 3, 12)):
        out["env_render"].append(check_kernel(
            torch, kernels, "env_render", KERNELS["env_render"][2],
            envelope(N, nhop, C, Ke), {}, f"C {C} Ke {Ke} hop {nhop}",
            prefix="20f"))
    for nhop in (960, 2048):
        N = int(DURATION * 48000.0) // nhop
        f0 = 70.0 + 230.0 * r(B, N)
        f0[:, ::7] = 0.0
        out["sample_cycles"].append(check_kernel(
            torch, kernels, "sample_cycles", KERNELS["sample_cycles"][2],
            (f0, nhop, 48000.0, N * nhop), {}, f"hop {nhop} at 48 kHz",
            prefix="20f"))
    args = envelope(1600, 80, 9, 9) + ((r(B, 9, 1600, 160) - 0.5),)
    out["noise_mod_ola_seg"].append(check_kernel(
        torch, kernels, "noise_mod_ola_seg", SEG_KERNEL[2], args, {},
        "C 9 Ke 9", prefix="20f"))
    del args
    torch.cuda.empty_cache()
    return out


def long_hop_shapes(torch, kernels, dev):
    """Phase 20h at 96 kHz with a 200 ms hop (hop 19200; the default
    ChunkConf: f0_floor 40, C = 19200), at kernel level against the twins,
    each timed beside its bound: harmonic_project_win at K = 80 past one
    frame's span (the warp kernel: a warp a frame, its live columns read
    from device memory), the cycle track's hop kernel (F0 70-1000 Hz: up to
    200 cycles a hop), noise_mod_ola's long kernel (4 bands, 4 envelope
    harmonics, on LONG_HOP_ROWS rows) and harmonic_project's row kernel
    (the frames of a window outside the cosine series, W = 38400: spans to
    9601 columns, those past its 6144 staged columns in chunks) -> {record:
    [case]}."""
    g = torch.Generator(device=dev).manual_seed(26)
    r = lambda *shape: torch.rand(shape, generator=g, device=dev)
    B, N, nhop, fs = BATCH, 40, 19200, 96000.0
    C, H, K = 19200, 4800, 80
    nx = N * nhop
    f0 = 70.0 + 930.0 * r(B, N)
    f0[:, ::7] = 0.0
    out = {}
    cyc = torch.remainder(torch.cumsum(r(B, nx) * 0.02, -1), 1.0)
    x = r(B, nx) - 0.5
    hw = 2.0 + (H - 2.0) * r(B, N)
    hw_int = torch.ceil(hw).to(torch.int32)
    kl = (r(B, N) * (K + 1)).to(torch.int32)
    geo = kernels._proj_win_geometry(nhop, C, K)
    phase("20h 96 kHz 200 ms projection geometry", geo[0] == 0,
          f"(frames a block, columns a chunk, bytes) {geo}: the warp "
          f"kernel; the frame's {8 * 2 * C} B past the block's "
          f"{kernels._SMEM_MAX}")
    out[PROJ_WARP] = [check_kernel(
        torch, kernels, "harmonic_project_win", KERNELS[
            "harmonic_project_win"][2], (x, cyc, hw, K, C - hw_int,
                                         C + hw_int + 1),
        dict(nhop=nhop, center=C, kl=kl), f"96 kHz 200 ms, warp {geo}",
        prefix="20h", reps=3)]
    del x, cyc, hw, hw_int, kl
    out["sample_cycles_hop"] = [check_kernel(
        torch, kernels, "sample_cycles", KERNELS["sample_cycles"][2],
        (f0, nhop, fs, nx), {}, "hop 19200 at 96 kHz", prefix="20h")]
    Bn, nbin = LONG_HOP_ROWS, nhop + 1
    bands = kernels.band_ranges(nbin, fs, (0.0, 2000.0, 4000.0, 6000.0,
                                           fs / 2))
    geo = kernels._noise_geometry(nhop, 4, 4, bands)
    phase("20h 96 kHz 200 ms noise geometry", geo[4] > 0,
          f"(frames a block, slots, bytes, threads, slots a chunk) {geo}")
    cyc = torch.remainder(torch.cumsum(r(Bn, nx) * 0.02, -1), 1.0)
    spec = [torch.randn((1, N, nbin), generator=g, device=dev).expand(
        Bn, N, nbin) for _ in range(2)]
    out["noise_mod_ola_long"] = [check_kernel(
        torch, kernels, "noise_mod_ola", KERNELS["noise_mod_ola"][2],
        (cyc, r(Bn, N, 4), (r(Bn, N, 4, 4) - 0.5) * 0.3,
         (r(Bn, N, 4, 4) - 0.5) * 0.3, 0.5 + r(Bn, N, 4), *spec,
         r(Bn, N, nbin), bands), {}, f"gains [{Bn}, {N}, {nbin}], C 4 Ke 4",
        prefix="20h", reps=3)]
    del cyc, spec
    torch.cuda.empty_cache()
    # a frame's live columns, its window's 2 hw + 1 around the centre, xw
    # a Hann-windowed signal
    R, W = B * N, 2 * C
    hwr = (2.0 + (H - 2.0) * r(R)).to(torch.int32)
    lo, hi = (C - hwr).to(torch.int32), (C + hwr + 1).to(torch.int32)
    d = torch.arange(W, device=dev)[None, :] - C
    xw = (r(R, W) - 0.5) * torch.where(
        d.abs() <= hwr[:, None],
        0.5 + 0.5 * torch.cos(math.pi * d / hwr[:, None]), 0.0)
    del d
    S, nbytes, G = kernels._project_geometry(W, K)
    chunked = int(((hi - lo) > S).sum())
    phase("20h 96 kHz 200 ms harmonic_project geometry",
          0 < S < W and 0 < chunked < R and G == 5,
          f"(staged columns, bytes, groups a pass) {(S, nbytes, G)}: "
          f"{R - chunked} rows staged once, {chunked} (spans past {S}) in "
          f"chunks of {S // 2}")
    out[PROJECT_ROWS] = [check_kernel(
        torch, kernels, "harmonic_project", KERNELS["harmonic_project"][2],
        ((r(R, W) - 0.5) * 4.0, xw, K, lo, hi), {},
        f"[{R}, {W}] K {K}", prefix="20h", reps=3)]
    del xw
    torch.cuda.empty_cache()
    return out


def proj_geometries(kernels, layer0, conf, nx):
    """harmonic_project_win's launch geometry (kernels._proj_win_geometry)
    for the main pass (hop nhop, C hh whole hops of the window's reach, K
    maxnhar) and the envelope pass (at the envelope decimation's rate, K
    maxnhar_e) of an analysis at conf on nx-sample rows."""
    D = layer0._env_decimation(conf, 4, nx)
    hop_e, h_e = conf.nhop // D, -(-conf.halfwin_max // D)
    C = -(-conf.halfwin_max // conf.nhop) * conf.nhop
    return (kernels._proj_win_geometry(conf.nhop, C, conf.maxnhar),
            kernels._proj_win_geometry(hop_e, -(-h_e // hop_e) * hop_e,
                                       conf.maxnhar_e))


def warp_calls(cases, f, geos):
    """The harmonic_project_win calls that run the warp kernel, taken out
    of a path's cases and full-batch records f -> (their cases, their
    records): the main pass's (x at the batch's rows, 2 or BATCH) where
    geos[0] (proj_geometries) is the warp kernel's, the envelope pass's
    (four channel rows a row) where geos[1] is; their record is
    PROJ_WARP's."""
    main = lambda rec: rec["shapes"][0][0] in (2, BATCH)
    warp = lambda rec: geos[0 if main(rec) else 1][0] == 0
    out = ([c for c in cases["harmonic_project_win"] if warp(c)],
           [rec for rec in f["harmonic_project_win"] if warp(rec)])
    cases["harmonic_project_win"] = [
        c for c in cases["harmonic_project_win"] if not warp(c)]
    f["harmonic_project_win"] = [
        rec for rec in f["harmonic_project_win"] if not warp(rec)]
    return out


def long_hop_phase(torch, mods, data50, sopt48, summary, join, by_phase,
                   noise20g, proj20g):
    """Phase 20h: wide_path at 48 kHz with a 50 ms hop (20b's options,
    hop 2400: the projection's main pass, whose 16-frame tile's span is
    past shared memory, runs the warp kernel, the cycle track its hop
    kernel, the noise its long kernel), each of the three held to its twin
    at full batch; then long_hop_shapes at 96 kHz / 200 ms.  Each new
    path's cases, full-batch records and launches go to a record of its
    own in summary (LONG_HOP; the long noise kernel's and the warp
    kernel's with 20g's, noise20g and proj20g: its cases, full-batch
    records and launches there); the rest joins its kernel's."""
    from libllsm2_tpu_torch import create_aoptions
    kernels = mods[0]
    opt50 = create_aoptions(fs=48000.0, thop=0.05, fnyq=12000.0,
                            chanfreq=(3000.0, 6000.0, 9000.0), nspec=513,
                            f0_floor=70.0, use_pallas=True)
    conf = opt50.conf
    C = -(-conf.halfwin_max // conf.nhop) * conf.nhop
    geos = proj_geometries(kernels, mods[1], conf, data50[0].shape[-1])
    warp = geos[0]
    span16 = 8 * (15 * conf.nhop + 2 * C)
    noise = kernels._noise_geometry(2400, 4, 4, kernels.band_ranges(
        2401, 48000.0, tuple(conf.chan_edges)))
    phase("20h 48 kHz 50 ms geometry", conf.nhop == 2400 and warp[0] == 0
          and geos[1][0] == 0
          and span16 + kernels._PROJ_STATIC > kernels._SMEM_MAX
          and noise[4] > 0,
          f"hop {conf.nhop}, C {C}: the 16-frame tile's span {span16} B "
          f"past {kernels._SMEM_MAX}; (frames a block, columns a chunk, "
          f"bytes) {warp}: the warp kernel, and for the envelope pass "
          f"{geos[1]}; the cycle track past 2048 samples; noise (frames a "
          f"block, slots, bytes, threads, slots a chunk) {noise}: the long "
          f"kernel")
    checked = FULL_CHECKED + ("harmonic_project_win", "sample_cycles",
                              "noise_mod_ola")
    cases, launches, f, _ = wide_path(
        torch, mods, "20h 48 kHz 50 ms", opt50, sopt48, data50,
        WIDE_PINS_DB["48 kHz 50 ms"], checked=checked,
        extra=("sample_cycles",), rows=BATCH_ROWS)
    by_phase["20h"] = launches
    # both passes' calls take the warp kernel (the envelope pass's: hop
    # 1200, C 1200, whose 16-frame tile would hold one block an SM)
    warp_cases, warp_full = warp_calls(cases, f, geos)
    phase("20h launches of the new paths", len(warp_full) >= 2
          and launches["sample_cycles"] == 2
          and launches["noise_mod_ola"] == 1,
          f"{len(warp_full)} of {launches['harmonic_project_win']} "
          f"harmonic_project_win launches of the warp kernel, "
          f"{launches['sample_cycles']} sample_cycles launches of the hop "
          f"kernel (analysis and synthesis), "
          f"{launches['noise_mod_ola']} noise_mod_ola launch of the long "
          f"kernel")
    redesigned_lines("20h", {"harmonic_project_win": warp_full,
                             "sample_cycles": f["sample_cycles"],
                             "noise_mod_ola": f["noise_mod_ola"]},
                     {"harmonic_project_win": f"warp kernel {warp}",
                      "sample_cycles": "hop kernel",
                      "noise_mod_ola": f"long kernel {noise}"})
    n_cases, n_full, n20g = noise20g
    p_cases, p_full, p20g = proj20g
    new = {PROJ_WARP: (p_cases + warp_cases, p_full + warp_full,
                       p20g + len(warp_full)),
           "sample_cycles_hop": (cases.pop("sample_cycles"),
                                 f.pop("sample_cycles"),
                                 launches["sample_cycles"]),
           "noise_mod_ola_long": (n_cases + cases.pop("noise_mod_ola"),
                                  n_full + f.pop("noise_mod_ola"),
                                  n20g + launches["noise_mod_ola"]),
           PROJECT_ROWS: ([], [], 0)}
    join(cases, f)
    for name, more in long_hop_shapes(torch, kernels,
                                      data50[0].device).items():
        new[name][0].extend(more)
    for name, (cs, full, n) in new.items():
        source, replaces, _ = KERNELS[LONG_HOP[name]]
        summary[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n,
            "max_abs_err": max(c["max_abs_err"] for c in cs),
            **{k: cs[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
            "cases": cs, "full_batch": full,
            "launches_by_phase": {"20g": n20g, "20h": n - n20g}
            if name == "noise_mod_ola_long" else
            {"20g": p20g, "20h": n - p20g} if name == PROJ_WARP
            else {"20h": n}}


def wide_phase(torch, mods, opt, sopt, data, summary, full, by_phase):
    """Phase 20 (cell wide): 20a creaky voice's conf, 20b 48 kHz at a 10 ms
    hop, 20c the denoiser's wide taps, 20d the Viterbi past 256 states,
    20e full band (deconv_full's wide path: its record DECONV_WIDE in
    summary), 20f the wide shapes no counted run takes; denoise_stats's
    cases and full-batch records of 20a, 20c and 20e (its wide path) go to
    the record DENOISE_WIDE, each other case joins its kernel's cases in
    summary, each full-batch record its kernel's in full, each counted
    run's launches by_phase -> 20f's noise_mod_ola_seg cases."""
    from libllsm2_tpu_torch import create_aoptions, create_soptions
    from libllsm2_tpu_torch.ops import f0 as f0mod
    from libllsm2_tpu_torch.ops import resample
    kernels, layer0, corpus = mods
    dev = data[0].device

    wide_ds = {"cases": [], "full_batch": []}

    def join(cases, f=None):
        for name, cs in cases.items():
            rec = summary[name]
            rec["cases"] += cs
            rec["max_abs_err"] = max(c["max_abs_err"] for c in rec["cases"])
        for name, recs in (f or {}).items():
            if name == FINISH:
                summary["denoise_apply"]["finish_full_batch"] += recs
            else:
                full[name] = full.get(name, []) + recs

    def join_wide(cases, f=None):
        """join, denoise_stats's cases and records its wide path's"""
        wide_ds["cases"] += cases.pop("denoise_stats", [])
        wide_ds["full_batch"] += (f or {}).pop("denoise_stats", [])
        join(cases, f)

    # 20a: creaky voice's conf, K = 160
    opt_c = dataclasses.replace(opt, conf=dataclasses.replace(
        opt.conf, maxnhar=160, fnyq=6000.0))
    cases, by_phase["20a"], f, shapes = wide_path(
        torch, mods, "20a creaky", opt_c, sopt, data, WIDE_PINS_DB["creaky"],
        checked=FULL_CHECKED + ("denoise_apply",))
    ks = [sh[0][-1] for name in ("denoise_stats", "denoise_apply", FINISH)
          for sh in shapes[name]]
    phase("20a K = 160", ks and all(k == 160 for k in ks),
          f"K of the denoiser's calls at 2 rows {ks}; denoise_stats's "
          f"geometry (chunk, columns a walk, shared bytes of each launch) "
          f"{kernels._denoise_geometry(160, 13, 7)}")
    redesigned_lines("20a", f, {
        "denoise_apply": "geometry (warps, blocks, pairs a warp, stage, "
        f"bytes) "
        f"{kernels._apply_geometry(160, BATCH * 1600, kernels._sm_count(dev))}"})
    join_wide(cases, f)
    # 20b: 48 kHz at a 10 ms hop, the rows resampled on the card
    x, f0, x_ref, nxv = data
    x48, ref48 = (resample.resample_to(v, 16000.0, 48000.0)
                  for v in (x, x_ref))
    data48 = (x48, f0[:, ::2].contiguous(), ref48,
              torch.full_like(nxv, x48.shape[-1]))
    del x48, ref48
    opt48 = create_aoptions(fs=48000.0, thop=0.01, fnyq=12000.0,
                            chanfreq=(3000.0, 6000.0, 9000.0), nspec=513,
                            f0_floor=70.0, use_pallas=True)
    sopt48 = dataclasses.replace(create_soptions(fs=48000.0), use_pallas=True)
    assert opt48.conf.nhop == 480
    cases, by_phase["20b"], f, shapes = wide_path(
        torch, mods, "20b 48 kHz", opt48, sopt48, data48,
        WIDE_PINS_DB["48 kHz"], checked=FULL_CHECKED + ("noise_mod_ola",))
    nbins = [sh[7][-1] for sh in shapes["noise_mod_ola"]]   # the gains
    bands = kernels.band_ranges(481, 48000.0, tuple(opt48.conf.chan_edges))
    geo = kernels._noise_geometry(480, 4, 4, bands)
    phase("20b nhop 480", nbins and all(n == 481 for n in nbins)
          and geo[0] > 0 and 2 * (geo[2] + 1024) <= 233472,
          f"bins of noise_mod_ola's calls at 2 rows {nbins}; geometry "
          f"(frames a block, slots, shared bytes, threads) {geo}: two "
          f"blocks an SM")
    redesigned_lines("20b", f, {"noise_mod_ola": f"geometry {geo}"})
    join(cases, f)
    # 20g: 48 kHz at a 20 ms hop (hop 960: the cycle track's long-hop
    # kernel, in the analysis and the synthesis), every fourth F0 frame
    data20 = (data48[0], f0[:, ::4].contiguous()) + data48[2:]
    del data48
    opt20 = create_aoptions(fs=48000.0, thop=0.02, fnyq=12000.0,
                            chanfreq=(3000.0, 6000.0, 9000.0), nspec=513,
                            f0_floor=70.0, use_pallas=True)
    assert opt20.conf.nhop == 960
    C20 = -(-opt20.conf.halfwin_max // 960) * 960
    geos20 = proj_geometries(kernels, layer0, opt20.conf,
                             data20[0].shape[-1])
    proj20 = geos20[0]
    cases, by_phase["20g"], f, _ = wide_path(
        torch, mods, "20g 48 kHz 20 ms", opt20, sopt48, data20,
        WIDE_PINS_DB["48 kHz 20 ms"],
        checked=FULL_CHECKED + ("harmonic_project_win", "sample_cycles",
                                "noise_mod_ola"),
        extra=("sample_cycles",), rows=BATCH_ROWS)
    n_cyc = by_phase["20g"]["sample_cycles"]
    phase("20g long cycle track", n_cyc == 2,
          f"nhop {opt20.conf.nhop} > 512: {n_cyc} sample_cycles launches "
          f"(analysis and synthesis) in the counted run, each a launch of "
          f"the long-hop kernel, {kernels._cycle_words(BATCH, 960, 384000)} "
          f"scratch words")
    geo20 = kernels._noise_geometry(960, 4, 4, kernels.band_ranges(
        961, 48000.0, tuple(opt20.conf.chan_edges)))
    n_noise = by_phase["20g"]["noise_mod_ola"]
    phase("20g long noise kernel", n_noise == 1 and geo20[4] > 0,
          f"nhop 960: the wide kernel's 16-frame block would not leave "
          f"room for two an SM, so the long kernel (frames a block, slots, "
          f"bytes, threads, slots a chunk) {geo20}: {n_noise} noise_mod_ola "
          f"launch in the counted run")
    # the main pass's calls take the warp kernel, the 16-frame tile's block
    # (C 1920: 145920 bytes) leaving room for one an SM; the envelope
    # pass's (hop 480, C 960) the 16-frame tile
    warp_cases, warp_full = warp_calls(cases, f, geos20)
    phase("20g warp projection", proj20[0] == 0 and geos20[1][0] == 16
          and len(warp_full) >= 1,
          f"hop 960, C {C20}: the 16-frame tile's "
          f"{8 * (15 * 960 + 2 * C20)} B would leave room for one block an "
          f"SM, so (frames a block, columns a chunk, bytes) {proj20}, the "
          f"envelope pass {geos20[1]}: {len(warp_full)} of "
          f"{by_phase['20g']['harmonic_project_win']} harmonic_project_win "
          f"launches of the warp kernel")
    redesigned_lines("20g", dict(f, harmonic_project_win=warp_full),
                     {"harmonic_project_win": f"warp kernel {proj20}",
                      "sample_cycles": "",
                      "noise_mod_ola": f"long kernel {geo20}"})
    noise20g = (cases.pop("noise_mod_ola"), f.pop("noise_mod_ola"), n_noise)
    proj20g = (warp_cases, warp_full, len(warp_full))
    join(cases, f)
    # 20h: 48 kHz at a 50 ms hop (hop 2400: the projection's warp kernel,
    # the cycle track's hop kernel, the long noise kernel), every tenth F0
    # frame; then 96 kHz at
    # a 200 ms hop at kernel level
    data50 = (data20[0], f0[:, ::10].contiguous()) + data20[2:]
    del data20
    long_hop_phase(torch, mods, data50, sopt48, summary, join, by_phase,
                   noise20g, proj20g)
    del data50
    torch.cuda.empty_cache()
    # 20c: denoise_stats on phase 5's full-batch call with wide taps
    calls, _ = capture_kernel_inputs(
        kernels, ("denoise_stats",),
        lambda: corpus.batched_pipeline(opt, sopt, x, f0, nxv, x_ref))
    args, kw = calls["denoise_stats"][0]
    del calls
    cases = []
    for label, (n1, n2) in WIDE_TAPS.items():
        taps = (layer0._hann_taps(n1), layer0._hann_taps(n2))
        cases.append(check_kernel(
            torch, kernels, "denoise_stats", KERNELS["denoise_stats"][2],
            args[:5] + taps, kw, f"{label}: {n1} + {n2} taps, geometry "
            f"{kernels._denoise_geometry(args[0].shape[-1], n1, n2)}",
            prefix="20c"))
    del args
    join_wide({"denoise_stats": cases})
    torch.cuda.empty_cache()
    # 20d: the Viterbi past 256 states, then the tracker at nbins 384 and
    # 2048
    cases, by_phase["20d"] = wide_viterbi(torch, kernels, f0mod,
                                          x[:WIDE_VITERBI_ROWS])
    join({VITERBI: cases})
    torch.cuda.empty_cache()
    # 20e: full band, deconv_full's wide kernel
    cases, f = fullband_phase(torch, mods, data, join_wide, by_phase)
    source, replaces, _ = KERNELS["deconv_full"]
    summary[DECONV_WIDE] = {
        "name": DECONV_WIDE, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": sum(v["deconv_full"] for k, v in by_phase.items()
                        if k.startswith("20e")),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        **{k: cases[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
        "cases": cases, "full_batch": f,
        "launches_by_phase": {k: v["deconv_full"] for k, v in by_phase.items()
                              if k.startswith("20e")}}
    # the wide denoiser: 20a's, 20c's and 20e's calls
    wide = {k: v["denoise_stats"] for k, v in by_phase.items()
            if k == "20a" or k.startswith("20e")}
    cs = wide_ds["cases"]
    source, replaces, _ = KERNELS["denoise_stats"]
    summary[DENOISE_WIDE] = {
        "name": DENOISE_WIDE, "route": "cuda", "source": source,
        "replaces": replaces, "launches": sum(wide.values()),
        "max_abs_err": max(c["max_abs_err"] for c in cs),
        **{k: cs[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
        "cases": cs, "full_batch": wide_ds["full_batch"],
        "launches_by_phase": wide}
    # 20f: the wide shapes no counted run takes
    extra = wide_shapes(torch, kernels, dev)
    seg = extra.pop("noise_mod_ola_seg")
    join(extra)
    return seg


def once_ms(torch, fn):
    """Milliseconds of one run of fn() by CUDA events, no warm-up."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        return 2
    if argv and (len(argv) != 2 or argv[0] not in ("breakdown", "rows")):
        print(__doc__, flush=True)
        return 2
    # "breakdown DIR" / "rows DIR": only phase 5's breakdown or the
    # rows-alone checks of phases 9, 10 and 12, of the package in DIR
    other = Path(argv[1]).resolve() if argv else None
    repo = other or Path(__file__).resolve().parent
    if not (repo / "libllsm2_tpu_torch" / "__init__.py").exists():
        print(f"FAIL: no libllsm2_tpu_torch package in {repo}", flush=True)
        return 1
    sys.path.insert(0, str(repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    print(card, flush=True)
    phase("1 device", bool(card), f"{torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    import libllsm2_tpu_torch as lt
    from libllsm2_tpu_torch import create_aoptions, create_soptions
    from libllsm2_tpu_torch.models import edits, layer0, layer1, pbp
    from libllsm2_tpu_torch.ops import _build, harmonics, kernels
    from libllsm2_tpu_torch.parallel import corpus
    if not other:
        from libllsm2_tpu_torch.models import coder
        from libllsm2_tpu_torch.utils import metrics, serialize, testsig

    t0 = time.perf_counter()
    _build.library()
    phase("2 build", True, f"{time.perf_counter() - t0:.1f} s "
          "(nvcc sm_90a, ctypes)")
    print("2 ptxas: " + "; ".join(
        f"{kernel_label(name)} {regs} registers, {spill} B spilled, {smem} B "
        "static smem" for name, regs, spill, smem in _build.resource_usage()),
        flush=True)

    opt_off = dataclasses.replace(create_aoptions(f0_floor=70.0),
                                  track_denoise=False, use_pallas=True)
    opt = create_aoptions(f0_floor=70.0, use_pallas=True)   # library default
    assert opt.track_denoise and opt.track_denoise_spectral \
        and opt.track_spectral_decimate == 4
    opt_mxu = dataclasses.replace(opt, hm_kernel="matmul")
    sopt = dataclasses.replace(create_soptions(), use_pallas=True)
    opt11 = create_aoptions(fs=11000.0, f0_floor=70.0, use_pallas=True)
    sopt11 = dataclasses.replace(create_soptions(fs=11000.0), use_pallas=True)
    assert opt11.conf.nhop == 55 and not opt11.fs_input
    t0 = time.perf_counter()
    data = fixtures(torch, dev)
    if other and argv[0] == "rows":
        print(f"rows alone of the package in {other}", flush=True)
        rows_report(torch, (layer0, layer1, pbp, edits), opt, sopt, data, dev)
        return 0
    if other:
        print(f"breakdown of the package in {other}", flush=True)
        mods = (harmonics, layer0, corpus, kernels)
        phase5_breakdown(torch, mods, opt, sopt, data)
        breakdown_kernels(torch, mods, opt, sopt, data)
        del data
        phase7_breakdown(torch, mods, opt11, fixtures(torch, dev, fs=11000.0))
        return 0
    data11 = fixtures(torch, dev, fs=11000.0)
    print(f"fixtures: {BATCH} x {DURATION} s at 16 and 11 kHz in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # phase 3: every kernel against its plain version on the inputs of
    # the path that runs it, 2 rows
    two = lambda d: (d[0][:2], d[1][:2], d[3][:2], d[2][:2])
    conf = opt.conf

    def mltsine():
        x, f0 = data[0][:2], data[1][:2]
        cyc = harmonics.sample_cycles(f0, conf.nhop, conf.fs, x.shape[-1])
        harmonics.harmonic_analysis(
            x, f0, cyc, nhop=conf.nhop, fs=conf.fs, max_k=conf.maxnhar,
            halfwin_max=conf.halfwin_max, rel_winsize=conf.rel_winsize,
            fnyq=conf.fnyq, window="mltsine")

    opt_lp = dataclasses.replace(opt, track_lowpass_hz=30.0)
    captures = [
        ("", PATH, lambda: corpus.batched_pipeline(opt, sopt, *two(data))),
        ("lowpass ", ("fir_frames",),
         lambda: corpus.batched_pipeline(opt_lp, sopt, *two(data))),
        ("matmul ", ("harmonic_project_mxu",),
         lambda: corpus.batched_pipeline(opt_mxu, sopt, *two(data))),
        ("11k ", ("refine_f0_full",),
         lambda: corpus.batched_pipeline(opt11, sopt11, *two(data11))),
        ("mltsine K=80 ", ("harmonic_project",), mltsine),
    ]
    cases = {name: [] for name in KERNELS}
    for prefix, names, run in captures:
        calls, _ = capture_kernel_inputs(kernels, names, run)
        for name in names:
            # the finish is denoise_apply's second launch: its cases there
            home = "denoise_apply" if name == FINISH else name
            tol = KERNELS[home][2]
            if not calls[name]:
                phase(f"3 {name}", False,
                      f"not called by {prefix or 'the main path'}")
            for i, (args, kw) in enumerate(calls[name]):
                label = f"finish {i}" if name == FINISH else f"{prefix}{i}"
                cases[home].append(check_kernel(
                    torch, kernels, name, tol, args, kw, label,
                    library=not cases[home]))
                for label, v_args, v_kw in variants(torch, name, args, kw):
                    cases[home].append(check_kernel(torch, kernels, name, tol,
                                                    v_args, v_kw, label))
        if "noise_bins" in names:
            # a frame-sharded render's first shard draws frames -2 and -1
            # (seqparallel: frame_base = -2): the same call from -2
            args, kw = calls["noise_bins"][0]
            cases["noise_bins"].append(check_kernel(
                torch, kernels, "noise_bins", KERNELS["noise_bins"][2],
                (args[0], -2) + tuple(args[2:]), kw, "frame_base -2"))
        if "noise_mod_ola" in names:
            # env_render on the main path's envelope coefficients: the
            # first five arguments of its noise_mod_ola call
            for i, (args, _) in enumerate(calls["noise_mod_ola"]):
                cases["env_render"].append(check_kernel(
                    torch, kernels, "env_render", KERNELS["env_render"][2],
                    args[:5], {}, f"noise_mod_ola {i}",
                    library=not cases["env_render"]))
        del calls
    # harmonic_project at K = 1 on the full-rate refine's first probe at
    # full batch ([B N, 2 H + 1], the twin's framing), which no path
    # launches since refine_f0_full took its calls
    k1 = refine_k1_operands(torch, kernels, opt11.conf, data11)
    cases["harmonic_project"].append(check_kernel(
        torch, kernels, "harmonic_project", KERNELS["harmonic_project"][2],
        k1, {}, "K=1 full shape", library=True))
    full = full_batch(torch, kernels, {"harmonic_project": [(k1, {})]}, "3")
    del k1
    torch.cuda.empty_cache()
    summary = {name: {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": 0,
                      "max_abs_err": max(c["max_abs_err"]
                                         for c in cases[name]),
                      **{k: cases[name][0][k] for k in
                         ("ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms")},
                      "cases": cases[name]}
               for name, (source, replaces, _) in KERNELS.items()
               if name != VITERBI}

    # phase 4: the denoiser-off path on 32 rows
    rows = torch.tensor(OFF_ROWS, device=dev)
    run_path(torch, kernels, corpus, "4 denoiser off", opt_off, sopt,
             tuple(d[rows] for d in data), NOISY_PINS_DB["denoiser off"],
             ("osc_bank", "harmonic_project_win", "deconv_full",
              "noise_mod_ola", "noise_bins", "sample_cycles"), (),
             noisy_tol=L0_NOISY_TOL_DB)
    # phase 5: the main path, the library default, on all 128 rows
    launches, snr5, f = run_path(torch, kernels, corpus, "5 library default",
                                 opt, sopt, data,
                                 NOISY_PINS_DB["library default"], PATH, PATH,
                                 noisy_tol=L0_NOISY_TOL_DB)
    for name in MAIN:
        summary[name]["launches"] = launches[name]
    summary["denoise_apply"]["finish_launches"] = launches[FINISH]
    summary["denoise_apply"]["finish_full_batch"] = f.pop(FINISH)
    full.update(f)
    batch_rows(torch, (kernels, layer0, corpus), opt, sopt, data, snr5)
    refine_phase(torch, kernels, harmonics, opt, data,
                 summary["refine_f0_dec"], full)
    (summary["harmonic_project_win"]["analysis_calls"],
     summary["osc_bank"]["render_calls"]) = phase5_breakdown(
        torch, (harmonics, layer0, corpus, kernels), opt, sopt, data)
    # phase 6: hm_kernel="matmul" at the library default, all 128 rows
    launches, snr6, f = run_path(torch, kernels, corpus, "6 matmul", opt_mxu,
                                 sopt, data, NOISY_PINS_DB["library default"],
                                 ("harmonic_project_mxu",) + MAIN_SIX,
                                 ("harmonic_project_mxu",),
                                 noisy_tol=L0_NOISY_TOL_DB)
    summary["harmonic_project_mxu"]["launches"] = \
        launches["harmonic_project_mxu"]
    full.update(f)
    diff = [a - b for a, b in zip(snr6, snr5)]
    print(f"6 matmul: snr - phase 5 snr: max |diff| "
          f"{max(map(abs, diff)):.4f} dB, noisy rows 0/1 {diff[0]:+.4f} / "
          f"{diff[1]:+.4f} dB, clean mean "
          f"{statistics.fmean(diff[BATCH // 2:]):+.4f} dB", flush=True)
    # phase 7: odd hop at 11 kHz, all 128 rows
    launches, _, f = run_path(torch, kernels, corpus, "7 odd hop", opt11,
                              sopt11, data11, ODD_HOP_PINS_DB,
                              ("refine_f0_full",) + MAIN_SIX,
                              ("refine_f0_full",), clean_min=None)
    phase("7 refine launches", launches["refine_f0_full"] == 1
          and launches["harmonic_project"] == 0,
          f"refine_f0_full {launches['refine_f0_full']} (1), "
          f"harmonic_project {launches['harmonic_project']} (0)")
    for name in ("refine_f0_full", "harmonic_project"):
        summary[name]["launches"] = launches[name]
    full.update(f)
    refine_full_phase(torch, kernels, harmonics, opt11, data11,
                      summary["refine_f0_full"], full)
    phase7_breakdown(torch, (harmonics, layer0, corpus, kernels), opt11,
                     data11)
    del data11
    # phase 8: an 11.025 kHz file through the public API
    public_11025(torch, kernels, lt, dev)
    # phase 9: the layer-1 round trip on the bench rows
    chunk, l9, rd_call = layer1_round_trip(torch, kernels, (layer0, layer1),
                                           opt, sopt, data)
    # env_render, which no library path runs: the full-batch chunk's
    # envelopes through layer0._render_envelopes(use_pallas=True)
    nx = chunk.nfrm * conf.nhop
    cyc = harmonics.sample_cycles(chunk.f0, conf.nhop, conf.fs, nx)
    render = lambda: layer0._render_envelopes(chunk, cyc, conf.nhop,
                                              use_pallas=True)
    kernels.reset_launches()
    calls, (env, base) = capture_kernel_inputs(kernels, ("env_render",),
                                               render)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    phase("9 env_render launches", launches["env_render"] == 1
          and bool(torch.isfinite(env).all() and torch.isfinite(base).all()),
          f"env, base {tuple(env.shape)} finite; {launches}")
    summary["env_render"]["launches"] = launches["env_render"]
    full.update(full_batch(torch, kernels, calls, "9"))
    rows = tuple(d.cpu().numpy() for d in data[:2])     # phase 11's source
    pool_rows = tuple(r[POOL_ROWS] for r in rows)       # phase 15's
    rows8 = [tuple(r[testsig.corpus_row(i)] for r in rows)   # phase 18b's
             for i in range(CLI_BATCH_FILES)]
    del chunk, cyc, env, base, data, calls
    # phase 10: pulse-by-pulse synthesis of LF rows
    _, l1 = pbp_phase(torch, kernels, (layer0, layer1, pbp), opt, sopt, dev)
    torch.cuda.empty_cache()
    # phase 11: the corpus from files (BASELINE config 5)
    launches, f0_call = corpus_phase(torch, kernels, opt, sopt, rows, dev)
    by_phase = {"11": launches}
    del rows
    # phase 11v: viterbi_scan against its twin on the calls of 9 and 11
    vit_cases, full[VITERBI] = viterbi_phase(torch, kernels, rd_call,
                                             f0_call)
    source, replaces, _ = KERNELS[VITERBI]
    summary[VITERBI] = {
        "name": VITERBI, "route": "cuda", "source": source,
        "replaces": replaces, "launches": l9[VITERBI],
        "max_abs_err": max(c["max_abs_err"] for c in vit_cases),
        **{k: vit_cases[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
        "cases": vit_cases}
    del rd_call, f0_call
    # phase 12: pitch x2, stretch x1.5 on phase 10's chunk (config 4)
    by_phase["12"] = edits_phase(torch, kernels, (layer0, edits), l1, sopt)
    # phase 13: the codec on phase 10's chunk (8- and 16-bit archives)
    by_phase["13"], v01 = codec_phase(torch, kernels, (layer0, layer1, coder,
                                                       serialize, metrics),
                                      l1, sopt)
    cc13 = coder.CoderConfig(conf=l1.conf)              # phase 17c's vectors
    vec13 = coder.encode(cc13, l1)
    l1_pool = l1.map(lambda a: a[:PBP_POOL_STREAMS].clone())
    del l1
    torch.cuda.empty_cache()
    # phase 14: the section-model Rd fit on nasal rows
    by_phase["14"] = nasal_phase(torch, kernels, (layer0, layer1), opt, dev)
    torch.cuda.empty_cache()
    # phase 15: streaming -- live analysis, serving, PbP serving, the codec
    # stream
    by_phase["15"] = stream_analysis_phase(
        torch, kernels, (layer0,), opt,
        tuple(r[[POOL_ROWS.index(i) for i in STREAM_ROWS]]
              for r in pool_rows))
    stream_serve_phase(torch, (layer0, metrics), opt, sopt, pool_rows)
    stream_pbp_phase(torch, (layer0, layer1, pbp, metrics), opt, sopt,
                     l1_pool)
    stream_codec_phase(torch, (layer0, coder), sopt, l1_pool.conf, v01)
    del pool_rows, l1_pool, v01
    torch.cuda.empty_cache()
    # phase 16: the library default (use_pallas=False), the analysis
    # options, noise_idft="fft" and the leaf DSP kit, on the bench rows
    t0 = time.perf_counter()
    data = fixtures(torch, dev)
    opt_plain, sopt_plain = create_aoptions(f0_floor=70.0), create_soptions()
    assert not (opt_plain.use_pallas or sopt_plain.use_pallas)
    by_phase["16a"], plain_ms, plain_peak = library_default_phase(
        torch, kernels, (layer0, corpus), data,
        (opt_plain, sopt_plain, opt, sopt))
    options, polar = analysis_options_phase(
        torch, kernels, (harmonics, layer0, corpus), data, opt, sopt)
    by_phase.update({f"16b {k}": v for k, v in options.items()})
    stats = summary["denoise_stats"]
    for i, (args, kw) in enumerate(polar):
        stats["cases"].append(check_kernel(
            torch, kernels, "denoise_stats", KERNELS["denoise_stats"][2],
            args, kw, f"16b pp, polar input at full batch {i}"))
    stats["max_abs_err"] = max(c["max_abs_err"] for c in stats["cases"])
    del polar
    seg_cases, seg_full, by_phase["16c"] = synthesis_phase(
        torch, kernels, (layer0,), data, opt, sopt)
    leaf_ops_phase(torch, data[0])
    print(f"16: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    # phase 17: the learned models (cell tts-train-serve)
    t0 = time.perf_counter()
    by_phase.update(tts_phase(torch, kernels, dev, opt, sopt))
    by_phase["17c"] = learned_codec_phase(torch, kernels, vec13, cc13, sopt)
    torch.cuda.empty_cache()
    phase("17d JAX weights on the card", *jax_weights_check(torch, dev))
    abs_phase(torch, data, dev)
    print(f"17: {time.perf_counter() - t0:.1f} s", flush=True)
    # phase 18: float64, the CLI and the profiler (cell cli-fp64)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    fp64_phase(torch, plain_ms, plain_peak)
    cli_phase(torch, rows8)
    profile_phase(torch, corpus, opt, sopt, data)
    print(f"18: {time.perf_counter() - t0:.1f} s", flush=True)
    # phase 19: 4 ranks on the card (cell multi-device)
    torch.cuda.empty_cache()
    by_phase["19"] = mesh_phase(torch, (layer0,), data, vec13, dev)
    del vec13
    # phase 20: the wide configurations (cell wide)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    seg_cases += wide_phase(torch, (kernels, layer0, corpus), opt, sopt,
                            data, summary, full, by_phase)
    print(f"20: {time.perf_counter() - t0:.1f} s", flush=True)
    del data
    for name in KERNELS:
        summary[name]["full_batch"] = full[name]
        summary[name]["launches_by_phase"] = {
            k: v[name] for k, v in by_phase.items()}
    # the segment-input entry: its launches from 16c's counted run
    name = "noise_mod_ola_seg"
    summary[name] = {
        "name": name, "route": "cuda", "source": SEG_KERNEL[0],
        "replaces": SEG_KERNEL[1], "launches": by_phase["16c"][name],
        "max_abs_err": max(c["max_abs_err"] for c in seg_cases),
        **{k: seg_cases[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
        "cases": seg_cases, "full_batch": seg_full,
        "launches_by_phase": {k: v[name] for k, v in by_phase.items()}}
    print(card, flush=True)

    print(json.dumps({"kernels": list(summary.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except Exception:
        traceback.print_exc()
        print("FAIL: chip smoke did not complete", flush=True)
        rc = 1
    sys.exit(rc)
