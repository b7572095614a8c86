"""Trainer base: the port of ``align_anything_tpu/trainers/base.py`` on one
GPU.

- ``TrainState`` / ``init_train_state`` / ``make_train_step``: the train
  state and ``compile_train_step``'s logic as a plain eager step.
- ``TrainerBase``: configs, the parallel config (``MeshConfig``), logging,
  loading an HF checkpoint (``models/hf_loader.py``) or a preset, the
  tokenizer, datasets and iterators, the optimizer, the train loop with its
  resume fast-forward, eval strategies, ``save_interval`` and SIGTERM
  handler, and checkpoints (``checkpoint.py``).  Subclasses define the
  datasets and the loss, as in JAX.

One process drives one device: ``cuda:0`` unless the caller passes
``device``.  The mesh machinery has no counterpart: ``shard_model_params``
is the identity, and a parallel config that needs more than one device (a
``data``, ``fsdp``, ``stage``, ``tensor``, ``sequence`` or ``expert`` axis
above 1) raises.  The step runs eagerly, no ``jit``.

Frozen modules (``FREEZE_FLAG_MODULES``, the multimodal trainers' flags)
are leaves labelled ``'frozen'`` (``trainers/optimizer.py``
``freeze_labels``) that do not require grad: the optimizer leaves them out
and autograd skips their backward.

LoRA and QLoRA (``init_peft``): the base is frozen (no gradient, no AdamW
state) and, with ``bnb_cfgs.use_bnb``, quantized to int4 or int8 in place;
the train state holds the adapters of ``models/lora.py``, attached to the
base per step by ``lora_policy``.  ``save_lora_merged`` exports the merged
model.  The generation-based eval of the RL trainers (``eval_generate``,
``generation_eval``, ``make_eval_prompt_iterator``) runs the port's
``generation/engine.py`` ``generate``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from align_anything_tpu_torch import checkpoint as ckpt_lib
from align_anything_tpu_torch.data import (
    ChatTemplate,
    DataIterator,
    HashTokenizer,
    load_tokenizer,
)
from align_anything_tpu_torch.models import config as model_config_lib
from align_anything_tpu_torch.models import lora as lora_lib
from align_anything_tpu_torch.models import quantization as quant
from align_anything_tpu_torch.models import transformer
from align_anything_tpu_torch.models.hf_loader import load_params
from align_anything_tpu_torch.trainers.optimizer import (
    ClippedAdamW,
    MultiSteps,
    Schedule,
    freeze_labels,
    make_optimizer,
)
from align_anything_tpu_torch.utils.config import namedtuple_to_dict
from align_anything_tpu_torch.utils.logger import Logger, is_main_process
from align_anything_tpu_torch.utils.profiling import StepTimer, maybe_trace
from align_anything_tpu_torch.utils.tools import (
    default_device,
    param_leaves,
    seed_everything,
    tree_map,
)


@dataclasses.dataclass
class TrainState:
    """params: the trainable tree (leaves with ``requires_grad``, updated in
    place); optimizer: the ``torch.optim.AdamW`` over its leaves, holding the
    moments (an ``AccumulatingOptimizer`` with gradient accumulation);
    step: steps taken so far (micro-steps with gradient accumulation)."""

    params: Any
    optimizer: Any
    step: int = 0


def init_train_state(params: dict, tx: ClippedAdamW | MultiSteps
                     ) -> TrainState:
    """``params``' leaves must be leaf tensors, and every leaf that ``tx``'s
    ``frozen_labels`` does not mark ``'frozen'`` must already require grad
    (as ``bridge.trainable_from_jax_tree`` makes them): such a leaf without
    it would get no gradient and silently never move.  A frozen leaf is
    set not to require grad, so autograd skips its backward."""
    leaves = param_leaves(params)
    labels = (['train'] * len(leaves) if tx.frozen_labels is None
              else param_leaves(tx.frozen_labels))
    if len(labels) != len(leaves):
        raise ValueError('init_train_state: frozen_labels does not match the '
                         'param tree')
    for t, label in zip(leaves, labels):
        if not t.is_leaf or (label == 'train' and not t.requires_grad):
            raise ValueError('init_train_state: every param must be a leaf '
                             'tensor, with requires_grad unless it is frozen')
        if label == 'frozen':
            t.requires_grad_(False)
    return TrainState(params=params, optimizer=tx.init(params))


def make_train_step(loss_fn: Callable[..., tuple[torch.Tensor, dict]],
                    tx: ClippedAdamW | MultiSteps, schedule: Schedule
                    ) -> Callable[..., tuple[TrainState, dict]]:
    """``loss_fn(params, *inputs) -> (loss, metrics)`` becomes
    ``step(state, *inputs) -> (state, metrics)``: loss and metrics,
    backward, global-norm clip, AdamW update at ``schedule(state.step)``.
    Metrics gain ``train/lr`` and ``train/grad_norm`` (before clipping)."""

    def step(state: TrainState, *inputs) -> tuple[TrainState, dict]:
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.params, *inputs)
        loss.backward()
        norm = tx.apply_(state.optimizer, state.step)
        metrics = dict(metrics)
        metrics['train/lr'] = schedule(state.step)
        metrics['train/grad_norm'] = norm
        return TrainState(state.params, state.optimizer, state.step + 1), \
            metrics

    return step


AXES = ('data', 'stage', 'fsdp', 'tensor', 'sequence', 'expert')


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The fields of the JAX ``parallel/mesh.py`` ``MeshConfig`` that a
    parallel config JSON sets.  On one device every axis resolves to 1: an
    axis of -1 takes what is left, which is 1, and an axis above 1 raises."""

    data: int = -1
    stage: int = 1
    fsdp: int = 1
    tensor: int = 1
    sequence: int = 1
    expert: int = 1
    pp_microbatches: int = 0
    pp_schedule: str = 'gpipe'
    remat: str = 'none'
    param_dtype: str = 'float32'
    compute_dtype: str = 'bfloat16'

    @classmethod
    def from_dict(cls, cfg: dict[str, Any] | None) -> 'MeshConfig':
        cfg = dict(cfg or {})
        mesh_cfg = cfg.get('mesh', cfg)
        fields = {f.name for f in dataclasses.fields(cls)}
        merged = {k: v for k, v in {**cfg, **mesh_cfg}.items() if k in fields}
        config = cls(**merged)
        wide = {ax: getattr(config, ax) for ax in AXES
                if getattr(config, ax) > 1}
        if wide:
            raise NotImplementedError(
                f'parallel config axes {wide} need more than one device: '
                'multi-GPU training is not ported yet (ROADMAP §1 item 14)')
        return config


class TrainerBase:
    """Shared machinery; subclasses define datasets + loss functions."""

    def __init__(self, cfgs, parallel_cfgs: dict | None = None,
                 device: torch.device | str | None = None) -> None:
        self.cfgs = cfgs
        self.parallel_cfgs = parallel_cfgs or {}
        self.device = default_device(device)
        self.global_step = 0
        self.use_lora = False
        self._preempted = False
        self.rng = seed_everything(cfgs.train_cfgs.seed or 42)

        self.mesh_config = MeshConfig.from_dict(self.parallel_cfgs)
        self.init_logger()
        self.init_models()
        self.init_datasets()
        self.init_engines()

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------

    def init_logger(self) -> None:
        lc = self.cfgs.logger_cfgs
        Logger.reset()
        self.logger = Logger(
            log_type=lc.log_type or 'none',
            log_dir=lc.output_dir,
            log_project=lc.log_project,
            log_run_name=lc.log_run_name,
            config=namedtuple_to_dict(self.cfgs),
        )

    def _resolve_model_config(self, name_or_path: str
                              ) -> model_config_lib.ModelConfig:
        if name_or_path and os.path.isdir(name_or_path):
            return model_config_lib.config_from_hf(name_or_path)
        if name_or_path in model_config_lib.PRESETS:
            return model_config_lib.PRESETS[name_or_path]()
        raise ValueError(
            f'model_name_or_path {name_or_path!r} is neither a checkpoint '
            f'dir nor a preset ({sorted(model_config_lib.PRESETS)})')

    def _apply_runtime_model_cfg(self, cfg: model_config_lib.ModelConfig
                                 ) -> model_config_lib.ModelConfig:
        tc = self.cfgs.train_cfgs
        compute = 'bfloat16' if (tc.bf16 or tc.bf16 is None) else 'float32'
        if tc.fp16:
            compute = 'float16'
        remat = (self.mesh_config.remat
                 if tc.gradient_checkpointing in (True, None) else 'none')
        cfg = cfg.replace(compute_dtype=compute, remat=remat)
        transformer.check_supported(cfg)
        return cfg

    def load_model(self, name_or_path: str,
                   next_key: Callable[[], torch.Generator]
                   ) -> tuple[dict, model_config_lib.ModelConfig]:
        """Params + config from an HF dir, or random init from a preset, on
        the trainer's device in fp32."""
        has_weights = name_or_path and os.path.isdir(name_or_path) and any(
            os.path.exists(os.path.join(name_or_path, f))
            for f in ('model.safetensors', 'model.safetensors.index.json'))
        if has_weights:
            params, cfg = load_params(name_or_path, device=self.device)
        else:
            cfg = self._resolve_model_config(name_or_path)
            params = transformer.init_params(cfg, next_key(),
                                             device=self.device)
        cfg = self._apply_runtime_model_cfg(cfg)
        return params, cfg

    def load_tokenizer_for(self, name_or_path: str, model_cfg,
                           padding_side: str = 'right'):
        if name_or_path and os.path.isdir(name_or_path) and any(
                os.path.exists(os.path.join(name_or_path, f))
                for f in ('tokenizer.json', 'tokenizer_config.json',
                          'vocab.json')):
            return load_tokenizer(
                name_or_path,
                model_max_length=self.cfgs.model_cfgs.model_max_length,
                padding_side=padding_side)
        tok = HashTokenizer(vocab_size=model_cfg.true_vocab_size
                            or model_cfg.vocab_size)
        tok.pad_token_id = model_cfg.pad_token_id
        tok.eos_token_id = model_cfg.eos_token_id
        tok.bos_token_id = model_cfg.bos_token_id
        return tok

    def _sync(self) -> None:
        """Wait for the device's queued work (for host timings)."""
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def next_rng(self) -> torch.Generator:
        """A fresh generator on the trainer's device, seeded by a draw from
        the root generator (JAX: ``jax.random.split`` of the root key)."""
        seed = int(torch.randint(0, 2 ** 62, (), generator=self.rng))
        return torch.Generator(device=self.device).manual_seed(seed)

    def shard_model_params(self, params: dict, model_cfg) -> dict:
        """One device: the params stay as they are."""
        return params

    def lora_requested(self) -> bool:
        """Whether the config turns LoRA on (``init_peft`` acts on it)."""
        lc = self.cfgs.lora_cfgs
        return bool(lc and lc.use_lora)

    def init_peft(self) -> bool:
        """LoRA / QLoRA setup shared by the trainers (JAX ``init_peft``;
        reference models/pretrained_model.py:196-252).

        ``bnb_cfgs.use_bnb``: quantize ``self.params`` in place, int4
        (``load_in_4bit``) or int8, weight-only (int8 ``int8_compute`` runs
        the int8 product).  ``lora_cfgs.use_lora``: the adapters as
        ``self.lora_params`` (trainable fp32 leaves) and the frozen,
        possibly quantized, base as ``self.base_params``.  Returns True
        when LoRA is on; the caller builds the train state over
        ``self.lora_params`` and attaches it per step with
        :meth:`lora_policy`.  ``lora_dropout`` is not read, as in JAX."""
        lc = self.cfgs.lora_cfgs
        bc = self.cfgs.bnb_cfgs
        self.use_lora = self.lora_requested()
        use_bnb = bool(bc and bc.use_bnb)
        if use_bnb and not self.use_lora:
            raise ValueError('bnb_cfgs.use_bnb quantizes the frozen base and '
                             'requires lora_cfgs.use_lora (QLoRA); full '
                             'fine-tuning needs fp weights')
        if not self.use_lora:
            return False
        if 'layers' not in self.params:
            # JAX fails here too, on the multimodal trees (ROADMAP R19)
            raise ValueError(
                ('bnb quantization' if use_bnb else 'LoRA')
                + ' supports the generic decoder param tree only')
        base = tree_map(lambda t: t.requires_grad_(False)
                        if isinstance(t, torch.Tensor) else t, self.params)
        if use_bnb:
            with torch.no_grad():
                if bc.load_in_4bit:
                    base = quant.quantize_decoder_int4(
                        base, num_experts=self.model_cfg.num_experts)
                else:
                    base = quant.quantize_decoder_int8(
                        base, num_experts=self.model_cfg.num_experts,
                        compute=bool(bc.int8_compute))
        self.params = base
        self.lora_r = int(lc.r or 16)
        self.lora_alpha = float(lc.lora_alpha or 16)
        self.lora_targets = tuple(lc.target_modules or ('q_proj', 'v_proj'))
        self.lora_params = tree_map(
            lambda t: t.requires_grad_(True),
            lora_lib.init_lora_params(self.model_cfg, self.next_rng(),
                                      r=self.lora_r,
                                      target_modules=self.lora_targets,
                                      device=self.device))
        self.base_params = base
        return True

    def lora_policy(self, lora_p: dict, base_p: dict) -> dict:
        """Adapters + the frozen base -> the policy's params (``LoraWeight``
        leaves; no weight math, see ``models/lora.py``)."""
        return lora_lib.attach_lora(base_p, lora_p, self.model_cfg,
                                    self.lora_r, self.lora_alpha)

    def merged_params(self, adapters: dict) -> dict:
        """The base with ``adapters`` baked in, every leaf dense: the
        export's tree."""
        with torch.no_grad():
            return quant.dequantize_decoder(lora_lib.merge_lora(
                self.base_params, adapters, self.model_cfg, self.lora_r,
                self.lora_alpha))

    def save_lora_merged(self, tag: int | None = None,
                         adapters: dict | None = None,
                         extra: dict | None = None,
                         state: TrainState | None = None) -> None:
        """The merged full-model export (save_full_model parity, reference
        supervised_trainer.py:441-450); a quantized base is dequantized for
        it.  ``state`` (default ``self.state``) is the train state the
        checkpoint holds, so a resume continues the adapters and their
        AdamW moments (JAX checkpoints the merged tree, ROADMAP R20);
        ``adapters`` default to its params, and ``extra`` leaves (a trained
        head) overwrite the merged tree's."""
        if not self.cfgs.logger_cfgs.output_dir:
            return
        state = self.state if state is None else state
        adapters = state.params if adapters is None else adapters
        merged = self.merged_params(adapters)
        if extra:
            merged = dict(merged, **extra)
        self.save_state_and_slice(state, self.model_cfg, self.tokenizer, tag,
                                  slice_params=merged)

    def compile_lora_train_step(self, loss_fn, tx, schedule):
        """``loss_fn(adapters, base, batch) -> (loss, metrics)`` becomes
        ``step(state, base, batch)`` over the adapter train state; the
        frozen base is an input, so gradients reach only the adapters."""
        return make_train_step(loss_fn, tx, schedule)

    # subclass hooks -----------------------------------------------------

    def init_models(self) -> None:
        raise NotImplementedError

    def init_datasets(self) -> None:
        raise NotImplementedError

    def init_engines(self) -> None:
        raise NotImplementedError

    # ------------------------------------------------------------------
    # engine building blocks
    # ------------------------------------------------------------------

    def make_chat_template(self, template_name: str | None,
                           tokenizer) -> ChatTemplate:
        return ChatTemplate(formatter=tokenizer, template=template_name)

    def make_iterator(self, dataset, batch_size: int, collator,
                      shuffle: bool = True) -> DataIterator:
        return DataIterator(
            dataset, batch_size, collator,
            seed=int(self.cfgs.train_cfgs.seed or 42), shuffle=shuffle,
            process_index=0, process_count=1)

    def padding_buckets(self) -> tuple[int, ...]:
        raw = self.cfgs.train_cfgs.padding_buckets or (256, 512, 1024, 2048, 4096)
        return tuple(int(b) for b in raw)  # CLI list values arrive as strings

    def on_epoch_start(self, epoch: int, total_epochs: int) -> None:
        """Per-epoch hook (e.g. dataset curriculum schedules). No-op by
        default."""

    def total_training_steps(self, iterator: DataIterator) -> int:
        return max(len(iterator) * int(self.cfgs.train_cfgs.epochs or 1), 1)

    # train_cfgs flag -> param-tree module key(s) to freeze (reference
    # models/pretrained_model.py:265-281 module names); every one names a
    # multimodal module, so no text-to-text run sets them
    FREEZE_FLAG_MODULES = (
        ('freeze_vision_tower', ('vision_tower',)),
        ('freeze_audio_tower', ('audio_tower',)),
        ('freeze_mm_proj', ('projector',)),
        ('freeze_vision_proj', ('projector',)),
        ('freeze_audio_proj', ('projector',)),
        ('freeze_language_model', ('language_model',)),
    )

    def frozen_modules(self) -> tuple[str, ...]:
        tc = self.cfgs.train_cfgs
        mods: list[str] = []
        for flag, names in self.FREEZE_FLAG_MODULES:
            if getattr(tc, flag, None):
                mods.extend(names)
        return tuple(dict.fromkeys(mods))

    def build_optimizer(self, total_steps: int):
        """(optimizer, schedule) from ``train_cfgs``; the modules that the
        freeze flags name (``frozen_modules``) are labelled frozen in
        ``self.params``."""
        tc = self.cfgs.train_cfgs
        mods = self.frozen_modules()
        frozen = None
        if mods:
            if getattr(self, 'params', None) is None:
                raise ValueError(
                    f'freeze flags name {mods} but the trainer has no '
                    'params to label; load the model before building the '
                    'optimizer')
            frozen = freeze_labels(self.params, mods)
        return make_optimizer(
            float(tc.learning_rate or 1e-5),
            frozen_labels=frozen,
            lr_scheduler_type=tc.lr_scheduler_type or 'constant',
            total_steps=total_steps,
            lr_warmup_ratio=float(tc.lr_warmup_ratio or 0.0),
            weight_decay=float(tc.weight_decay or 0.0),
            adam_betas=tuple(tc.adam_betas or (0.9, 0.95)),
            adam_epsilon=float(tc.adam_epsilon or 1e-8),
            max_grad_norm=float(tc.max_grad_norm or 0.0),
            gradient_accumulation_steps=int(tc.gradient_accumulation_steps or 1),
        )

    def trainable(self, params: dict) -> dict:
        """The loaded params as the train state's leaves: fp32 leaf tensors
        with ``requires_grad`` (``init_train_state`` turns it off on the
        leaves of frozen modules)."""
        return tree_map(lambda t: t.float().requires_grad_(True), params)

    def build_train_state(self, params: dict, tx) -> TrainState:
        return init_train_state(params, tx)

    def compile_train_step(
        self, loss_fn: Callable[[dict, dict], tuple[torch.Tensor, dict]], tx,
        schedule,
    ) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
        """loss_fn(params, batch) -> (loss, metrics) becomes the eager
        update step (``make_train_step``)."""
        return make_train_step(loss_fn, tx, schedule)

    def put_batch(self, batch: dict) -> dict:
        """Host batch (numpy) -> tensors on the trainer's device, copied
        without blocking from pinned memory on a GPU.  Non-array entries
        are dropped."""
        out = {}
        for k, v in batch.items():
            if not isinstance(v, np.ndarray):
                continue
            t = torch.from_numpy(v)
            if self.device.type == 'cuda':
                t = t.pin_memory().to(self.device, non_blocking=True)
            else:
                t = t.to(self.device)
            out[k] = t
        return out

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------

    def train_step(self, batch: dict) -> dict[str, float]:
        raise NotImplementedError

    def eval(self) -> dict[str, float]:
        return {}

    def eval_generate(self, params, batch: dict) -> dict:
        """Generation hook for ``generation_eval``: ``self.gen_cfg``'s
        completions of the batch's left-padded prompts."""
        from align_anything_tpu_torch.generation import generate  # noqa: PLC0415

        batch = self.put_batch(batch)
        return generate(params, self.model_cfg, self.gen_cfg,
                        batch['input_ids'], batch['attention_mask'],
                        self.next_rng())

    def generation_eval(self, params, score_fn=None) -> dict[str, float]:
        """Generation-based RL eval (reference rl_trainer.py:288-329):
        sample completions for every eval prompt, print a Prompt/Generated
        table, and log ``eval/*`` metrics (plus the mean reward when a
        scorer is given)."""
        it = getattr(self, 'eval_iterator', None)
        if it is None:
            return {}
        prompts: list[str] = []
        generateds: list[str] = []
        rewards: list[float] = []
        lengths: list[float] = []
        pad = self.tokenizer.pad_token_id
        for batch in it.epoch_batches(0):
            gen = self.eval_generate(params, batch)
            if score_fn is not None:
                rewards.extend(score_fn(gen['sequences'],
                                        gen['attention_mask']).float()
                               .cpu().reshape(-1).tolist())
            comp = gen['completions'].cpu().numpy()
            lengths.extend((comp != pad).sum(-1).astype(float).tolist())
            prompts.extend(self.tokenizer.batch_decode(
                [[t for t in row if t != pad]
                 for row in np.asarray(batch['input_ids'])],
                skip_special_tokens=True))
            generateds.extend(self.tokenizer.batch_decode(
                [[t for t in row if t != pad] for row in comp],
                skip_special_tokens=True))
        self.logger.print_table(
            title='Evaluating...', columns=['Prompt', 'Generated'],
            rows=list(zip(prompts, generateds)), max_num_rows=5)
        metrics: dict[str, float] = {
            'eval/mean_generated_length': float(np.mean(lengths or [0.0])),
        }
        if rewards:
            metrics['eval/reward'] = float(np.mean(rewards))
        self.logger.log(metrics, step=self.global_step)
        return metrics

    def make_eval_prompt_iterator(self, dataset_cls, tokenizer) -> None:
        """Build ``self.eval_iterator`` over ``data_cfgs.eval_datasets``
        prompt-only rows (RL eval); no-op when unset."""
        dc = self.cfgs.data_cfgs
        self.eval_iterator = None
        if not dc.eval_datasets:
            return
        template = self.make_chat_template(
            dc.eval_template or dc.train_template, tokenizer)
        max_len = int(self.cfgs.model_cfgs.model_max_length or 2048)
        ds = dataset_cls(
            dc.eval_datasets, template, tokenizer, max_length=max_len,
            split=dc.eval_split, size=dc.eval_size,
            data_files=dc.eval_data_files)
        # one device: the global batch is the per-device batch
        bs = int(self.cfgs.train_cfgs.per_device_eval_batch_size or 1)
        self.eval_iterator = self.make_iterator(
            ds, bs, ds.get_collator(buckets=self.padding_buckets()),
            shuffle=False)

    def _install_preemption_handler(self):
        """SIGTERM (preemption) triggers a save at the NEXT step boundary,
        so the checkpoint is always consistent.  Returns a restore
        callback."""
        import signal  # noqa: PLC0415

        self._preempted = False

        def on_sigterm(signum, frame):
            self._preempted = True

        try:
            prev = signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:  # not the main thread (tests)
            return lambda: None
        return lambda: signal.signal(signal.SIGTERM, prev)

    def train(self) -> None:
        tc = self.cfgs.train_cfgs
        epochs = int(tc.epochs or 1)
        steps_per_epoch = len(self.train_iterator)
        total = steps_per_epoch * epochs
        if total == 0:
            # a config that would silently train zero steps is a data-path
            # bug, not a run
            raise ValueError(
                f'training would run 0 steps: dataset yields '
                f'{steps_per_epoch} batches/epoch at global batch size '
                f'{self.train_iterator.batch_size} '
                f'({len(self.train_iterator.dataset)} samples, '
                f'drop_last={self.train_iterator.drop_last}) x {epochs} '
                'epochs — add data or lower per_device_train_batch_size')
        self.logger.print(f'***** Running training: {total} steps '
                          f'({epochs} epochs x {steps_per_epoch}) on '
                          f'{self.device} *****')
        start_epoch = self.global_step // max(steps_per_epoch, 1)
        skip = self.global_step % max(steps_per_epoch, 1)
        t0 = time.monotonic()
        timer = StepTimer()
        profile_dir = self.cfgs.logger_cfgs.profile_dir
        restore_handler = self._install_preemption_handler()
        for epoch in range(start_epoch, epochs):
            self.on_epoch_start(epoch, epochs)
            for i, batch in enumerate(self.train_iterator.epoch_batches(epoch)):
                if epoch == start_epoch and i < skip:
                    continue  # deterministic resume fast-forward
                with maybe_trace(profile_dir, self.global_step):
                    metrics = self.train_step(batch)
                n_tokens = int(np.prod(batch['input_ids'].shape)) \
                    if isinstance(batch.get('input_ids'), np.ndarray) else 0
                metrics.update(timer.tick(n_tokens))
                self.global_step += 1
                metrics['train/epoch'] = epoch
                metrics['train/steps_per_sec'] = self.global_step / (
                    time.monotonic() - t0)
                self.logger.log(metrics, step=self.global_step)
                if self.global_step % 10 == 0 or self.global_step == 1:
                    printable = {k: (f'{v:.4f}' if isinstance(v, float) else v)
                                 for k, v in metrics.items()}
                    self.logger.print(f'step {self.global_step}: {printable}')
                if (tc.eval_strategy == 'steps' and tc.eval_interval
                        and self.global_step % int(tc.eval_interval) == 0):
                    self.eval()
                save_interval = self.cfgs.logger_cfgs.save_interval
                if save_interval and self.global_step % int(save_interval) == 0:
                    self.save(tag=self.global_step)
                if self._preempted:
                    self.logger.print(
                        f'SIGTERM received: checkpointing at step '
                        f'{self.global_step} and exiting (resume with '
                        f'load_checkpoint=True)')
                    self.save(tag=self.global_step)
                    ckpt_lib.wait_for_saves()
                    restore_handler()
                    return
            if tc.eval_strategy == 'epoch':
                self.eval()
        ckpt_lib.wait_for_saves()
        restore_handler()

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def save(self, tag: int | None = None) -> None:
        raise NotImplementedError

    def save_state_and_slice(self, state: TrainState, model_cfg,
                             tokenizer=None, tag: int | None = None,
                             slice_params: dict | None = None) -> None:
        """The train-state checkpoint of ``state`` and the HF slice of
        ``slice_params`` (default: ``state.params``)."""
        out = self.cfgs.logger_cfgs.output_dir
        if not out:
            return
        tag = tag if tag is not None else self.global_step
        if self.cfgs.train_cfgs.save_checkpoint:
            # asynchronous, as JAX's: the write overlaps the next steps; the
            # loop (and the preemption path) wait for it before returning
            ckpt_lib.save_train_state(
                out, tag, state, keep=self.cfgs.logger_cfgs.save_total_limit,
                wait=False)
        if is_main_process():
            path = ckpt_lib.save_hf_slice(
                out, tag, state.params if slice_params is None
                else slice_params, model_cfg, tokenizer)
            self.logger.print(f'saved HF slice to {path}')

    def maybe_resume(self, state: TrainState) -> TrainState:
        if not self.cfgs.train_cfgs.load_checkpoint:
            return state
        out = self.cfgs.logger_cfgs.output_dir
        found = ckpt_lib.latest_checkpoint(out) if out else None
        if found is None:
            self.logger.print('load_checkpoint=True but no checkpoint found; '
                              'starting fresh')
            return state
        path, step = found
        state = ckpt_lib.restore_train_state(path, state)
        self.global_step = step
        self.logger.print(f'resumed from {path} at step {step}')
        return state


class FreezesNothingMixin:
    """The multimodal RL trainers' freezing, as JAX's: none (ROADMAP §3
    R13).  JAX's PPO builds its optimizers with ``make_optimizer`` and no
    frozen labels, and its GRPO's ``build_optimizer`` labels
    ``self.params``, which those trainers never set: the modules the
    freeze flags name train.  One line at start-up names them."""

    def frozen_modules(self) -> tuple[str, ...]:
        return ()

    def init_engines(self) -> None:
        named = TrainerBase.frozen_modules(self)
        if named:
            self.logger.print(
                f'freeze flags name {named}; as in JAX, the multimodal RL '
                'trainers freeze nothing, so they train them (ROADMAP §3 '
                'R13)')
        super().init_engines()
