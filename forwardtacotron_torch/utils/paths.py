"""Data and checkpoint directory layout (the port's copy of
forwardtacotron_tpu/utils/paths.py, the on-disk layout of reference
utils/paths.py:10-45 with checkpoints under a configurable
``checkpoint_path``)."""

from pathlib import Path
from typing import Union


class Paths:

    DATA_SUBDIRS = ('mel', 'gta', 'alg', 'att_pred', 'raw_pitch',
                    'phon_pitch', 'phon_energy', 'speaker_emb',
                    'mean_speaker_emb', 'quant')

    def __init__(self,
                 data_path: Union[str, Path],
                 tts_id: str,
                 checkpoint_path: Union[str, Path, None] = None) -> None:
        self.data = Path(data_path).expanduser().resolve()
        base = Path(checkpoint_path).expanduser().resolve() if checkpoint_path \
            else self.data.parent / 'checkpoints'
        self.base = base

        for sub in self.DATA_SUBDIRS:
            setattr(self, sub, self.data / sub)

        self.model_output = base / 'model_output'
        self.taco_checkpoints = base / f'{tts_id}.tacotron'
        self.taco_log = self.taco_checkpoints / 'logs'
        self.forward_checkpoints = base / f'{tts_id}.forward'
        self.forward_log = self.forward_checkpoints / 'logs'

        # pickled metadata
        self.train_dataset = self.data / 'train_dataset.pkl'
        self.val_dataset = self.data / 'val_dataset.pkl'
        self.text_dict = self.data / 'text_dict.pkl'
        self.speaker_dict = self.data / 'speaker_dict.pkl'
        self.duration_stats = self.data / 'duration_stats.pkl'

        self.create_paths()

    def create_paths(self) -> None:
        for sub in self.DATA_SUBDIRS:
            getattr(self, sub).mkdir(parents=True, exist_ok=True)
        for d in (self.taco_checkpoints, self.forward_checkpoints,
                  self.taco_log, self.forward_log):
            d.mkdir(parents=True, exist_ok=True)

    @classmethod
    def from_config(cls, config: dict) -> 'Paths':
        return cls(data_path=config['data_path'],
                   tts_id=config['tts_model_id'],
                   checkpoint_path=config.get('checkpoint_path'))
