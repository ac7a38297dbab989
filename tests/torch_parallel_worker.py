"""One rank of the port's data-parallel runs: the CPU tests of
tests/test_torch_parallel_train.py, the card tests of
tests/test_torch_cuda.py and ``chip_smoke.py``'s data-parallel phase.

    python tests/torch_parallel_worker.py <job.pt> <out prefix>

with torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT). A job (``torch.save``d by ``launch``) names a trainer
('forward', 'multi' or 'taco'), its config, the model's state_dict, every
rank's batch (numpy, each padded to its own shape), the device ('cpu',
'cuda' for each rank's card, or one named card that every rank shares),
the process group's 'backend' device (gloo for 'cpu', NCCL for 'cuda';
default: the device), the teacher's r, the number of steps and
'plot_every' (rank 0 alone takes the trainer's ``plot_outputs`` of its
batch's first item after every so many steps, as the training loops do);
or it holds a list of such 'jobs', run in turn in one process group. The
rank joins the group through ``initialize_distributed`` (twice: the second
call must be a no-op), pads each batch to the ranks' common shape, takes
the steps with the trainer's ``train_step`` and saves, for each job, the
first step's metrics and state_dict, the last step's state_dict, every
step's metrics and wall seconds and the recurrent kernels' launch counts
to ``<out prefix><rank>.pt``. It imports the port only.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


# the log floor that the collators pad mels with (data/dataset.py)
PAD_VALUE = -11.5129


def make_items(n, seed, n_mels, tokens=(5, 12), frames=(1, 3),
               speaker_dims=0):
    """``n`` training items, as the forward data set holds them, made from
    ``seed`` with numpy: ``tokens`` phonemes (inclusive range), ``frames``
    frames a token, the first token unvoiced, random mels, pitch, energy
    and (with ``speaker_dims``) a non-negative unit-norm speaker
    embedding."""
    import numpy as np
    rs = np.random.RandomState(seed)
    items = []
    for _ in range(n):
        ln = int(rs.randint(tokens[0], tokens[1] + 1))
        dur = rs.randint(frames[0], frames[1] + 1, ln).astype(np.float32)
        pitch = rs.randn(ln).astype(np.float32)
        pitch[0] = 0.0
        item = {'x': rs.randint(1, 40, ln), 'dur': dur, 'pitch': pitch,
                'energy': rs.rand(ln).astype(np.float32),
                'mel': rs.randn(int(dur.sum()), n_mels).astype(np.float32)}
        if speaker_dims:
            e = np.abs(rs.randn(speaker_dims)).astype(np.float32)
            item['speaker_emb'] = e / np.linalg.norm(e)
        items.append(item)
    return items


def _round_up(n, m):
    return -(-n // m) * m


def collate(items, n_tok=None, n_frames=None, multiple=8):
    """A batch of ``items`` padded as the forward collator pads them
    (tokens and frames + 1 to multiples of ``multiple``, mels with the log
    floor, the pitch condition 0 at padding, 1 unvoiced, 2 voiced), or to
    the given shape."""
    import numpy as np
    x_len = np.array([len(it['x']) for it in items])
    mel_len = np.array([len(it['mel']) for it in items])
    n_tok = n_tok or _round_up(int(x_len.max()), multiple)
    n_frames = n_frames or _round_up(int(mel_len.max()) + 1, multiple)
    batch = {'x_len': x_len, 'mel_len': mel_len}
    for key, dtype in (('x', np.int64), ('dur', np.float32),
                       ('pitch', np.float32), ('energy', np.float32)):
        batch[key] = np.stack([np.pad(it[key], (0, n_tok - len(it[key])))
                               for it in items]).astype(dtype)
    batch['mel'] = np.stack([
        np.pad(it['mel'], ((0, n_frames - len(it['mel'])), (0, 0)),
               constant_values=PAD_VALUE) for it in items])
    valid = np.arange(n_tok)[None] < x_len[:, None]
    batch['pitch_cond'] = np.where(valid, np.where(batch['pitch'] == 0, 1, 2),
                                   0).astype(np.int64)
    if 'speaker_emb' in items[0]:
        batch['speaker_emb'] = np.stack([it['speaker_emb'] for it in items])
    return batch


def rank_batches(items, world, multiple=8):
    """Each rank's equal share of the items' rows, collated at its own
    shape, and the global batch of all of them at the largest shape (what
    the ranks pad to)."""
    rows = len(items) // world
    batches = [collate(items[r * rows:(r + 1) * rows], multiple=multiple)
               for r in range(world)]
    return batches, collate(items, max(b['x'].shape[1] for b in batches),
                            max(b['mel'].shape[1] for b in batches))


def no_dropout(model):
    """Every dropout of the model (the teacher's zoneout too) off."""
    import torch
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        if hasattr(m, 'dropout') and isinstance(m.dropout, float):
            m.dropout = 0.0
    if hasattr(model, 'decoder'):
        model.decoder.zoneout = 0.0
    return model


def make_trainer(job, device):
    """(trainer, model) of the job on ``device``, the model loaded from
    the job's state_dict with its dropout off."""
    import torch

    from forwardtacotron_torch.models.registry import init_tts_model
    from forwardtacotron_torch.models.tacotron import Tacotron
    from forwardtacotron_torch.train.forward_trainer import (
        ForwardTrainer, MultiForwardTrainer)
    from forwardtacotron_torch.train.taco_trainer import TacoTrainer
    from forwardtacotron_torch.utils.paths import Paths

    config = job['config']
    paths = Paths.from_config(config)
    kind = job['trainer']
    if kind == 'taco':
        model = Tacotron.from_config(config)
        trainer = TacoTrainer(paths, None, config, device=device)
    else:
        model = init_tts_model(config)
        cls = MultiForwardTrainer if kind == 'multi' else ForwardTrainer
        trainer = cls(paths, None, config, device=device)
    missing, unexpected = model.load_state_dict(job['state_dict'],
                                                strict=False)
    assert not unexpected and all(k.endswith('.pe') for k in missing)
    return trainer, no_dropout(model).to(trainer.device)


def train_steps(job, batch, device):
    """The job's steps on ``batch`` (numpy, at the ranks' common shape),
    with rank 0's plots of the job's 'plot_every': (each step's metrics as
    floats, the state_dict on the CPU after the first step, each step's
    wall seconds, the state_dict on the CPU after the last step)."""
    from types import SimpleNamespace

    import torch

    from forwardtacotron_torch.parallel.mesh import process_index
    from forwardtacotron_torch.train.state import create_train_state

    trainer, model = make_trainer(job, device)
    state = create_train_state(model, trainer.tx)
    batch = dict(batch)
    if job['trainer'] != 'taco':
        batch['pitch_target'] = batch['pitch'].copy()
        batch['energy_target'] = batch['energy'].copy()
    dev_batch = trainer.device_batch(batch)
    metrics, times, first = [], [], None
    plot_every = job.get('plot_every', 0)
    plot_session = SimpleNamespace(val_sample=batch, r=job.get('r'))
    for step in range(1, job.get('steps', 1) + 1):
        t0 = time.perf_counter()
        if job['trainer'] == 'taco':
            m, _ = trainer.train_step(state, dev_batch, job['r'])
        else:
            m = trainer.train_step(state, dev_batch)
        metrics.append({k: float(v) for k, v in m.items()})
        times.append(time.perf_counter() - t0)
        if first is None:
            first = {k: v.detach().cpu().clone()
                     for k, v in model.state_dict().items()}
        if plot_every and step % plot_every == 0 and process_index() == 0:
            arrays = trainer.plot_outputs(state, plot_session)
            assert arrays['mel'], 'a plot without mels'
    last = {k: v.detach().cpu().clone()
            for k, v in model.state_dict().items()}
    return metrics, first, times, last


def main(job_path: str, out_prefix: str) -> None:
    import torch

    from forwardtacotron_torch.ops.hopper import rnn, rnn_train
    from forwardtacotron_torch.parallel.mesh import (initialize_distributed,
                                                     process_count,
                                                     process_index,
                                                     rank_device)
    from forwardtacotron_torch.train.forward_trainer import common_shape

    job = torch.load(job_path, weights_only=False)
    # gloo for 'cpu' (also ranks sharing one card), NCCL for 'cuda'
    backend = job.get('backend', job['device'])
    assert initialize_distributed(backend)
    assert initialize_distributed(backend), 'a second call is a no-op'
    rank, world = process_index(), process_count()
    device = torch.device(job['device'])
    if device.type == 'cuda':
        if device.index is None:
            device = rank_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    results = []
    for sub in job.get('jobs', [job]):
        assert world == len(sub['batches'])
        for counts in (rnn.launches, rnn_train.launches):
            for key in counts:
                counts[key] = 0
        batch = common_shape(sub['batches'][rank])
        metrics, state, times, last = train_steps(sub, batch, device)
        results.append({
            'metrics': metrics[0], 'step_metrics': metrics, 'state': state,
            'last_state': last,
            'times': times, 'world': world, 'device': str(device),
            'shape': (batch['x'].shape, batch['mel'].shape),
            'launches': {**rnn.launches, **rnn_train.launches}})
    torch.save(results, f'{out_prefix}{rank}.pt')
    torch.distributed.destroy_process_group()


def step_difference(got, want, lr: float, mixed_precision: bool):
    """How far one optimizer step's state_dict ``got`` lies from ``want``,
    in the terms of tests/test_torch_trainer.py's tolerances: (the largest
    BatchNorm running-statistic error over max(1, max |want|), the
    parameters' difference: bf16 the mean |got - want| in learning rates,
    float32 the share of elements more than 1e-5 relative + lr / 100
    apart, or infinity if one is more than 2 lr apart)."""
    import torch
    diffs, n_far, n_all, stat_err = [], 0, 0, 0.0
    for key, w in want.items():
        if not w.is_floating_point() or key.endswith('step'):
            continue
        g, w = got[key].float(), w.float()
        if key.endswith(('running_mean', 'running_var')):
            stat_err = max(stat_err, float((g - w).abs().max())
                           / max(1.0, float(w.abs().max())))
        elif mixed_precision:
            diffs.append((g - w).abs().flatten())
        else:
            d = (g - w).abs()
            n_far += int((d > 1e-5 * w.abs() + 1e-2 * lr).sum())
            n_all += d.numel()
            if float(d.max()) > 2.001 * lr:
                return stat_err, float('inf')
    if mixed_precision:
        return stat_err, float(torch.cat(diffs).mean()) / lr
    return stat_err, n_far / max(n_all, 1)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def launch(job, tmp_dir, timeout: float = 300.0):
    """Run the job's world of ranks (one process each, as many as the job
    has batches) and return each rank's result (for a job of 'jobs', its
    list of results). Every process runs under ``timeout`` seconds; if one
    fails or times out, all are killed and this raises with the ranks'
    output."""
    import torch

    tmp_dir = Path(tmp_dir)
    job_path = tmp_dir / 'job.pt'
    torch.save(job, str(job_path))
    world = len(job.get('jobs', [job])[0]['batches'])
    run_ranks([sys.executable, str(Path(__file__).resolve()), str(job_path),
               str(tmp_dir / 'rank')], world, tmp_dir, timeout)
    results = [torch.load(str(tmp_dir / f'rank{r}.pt'), weights_only=False)
               for r in range(world)]
    return results if 'jobs' in job else [r[0] for r in results]


def run_ranks(cmd, world: int, log_dir, timeout: float, env=None):
    """``cmd`` once per rank of a ``world`` with torchrun's environment
    (and ``env``), output to ``<log_dir>/rank<r>.log``. Returns when all
    have exited 0; when one fails or ``timeout`` seconds pass, kills every
    rank and raises with their output."""
    port = free_port()
    procs, logs = [], []
    for rank in range(world):
        log = open(Path(log_dir) / f'rank{rank}.log', 'w')
        logs.append(log)
        procs.append(subprocess.Popen(
            cmd, cwd=str(REPO), stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, **(env or {}), RANK=str(rank),
                     WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                     MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                     OMP_NUM_THREADS='1')))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(
            f'ranks exited {codes} (timeout {timeout:g} s):\n' + '\n'.join(
                f'--- rank {r}\n'
                + (Path(log_dir) / f'rank{r}.log').read_text()[-4000:]
                for r in range(world)))


if __name__ == '__main__':
    main(sys.argv[1], sys.argv[2])
