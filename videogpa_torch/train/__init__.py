"""DPO post-training: preference pairs, loss, LoRA, the train step."""

from videogpa_torch.train.dataset import DPODataset, collate, train_val_split
from videogpa_torch.train.lora import export_peft, import_peft, lora_init, merge_lora
from videogpa_torch.train.loss import DPOLoss, LossOutput, SFTLoss, create_loss_strategy

__all__ = [
    "DPOLoss",
    "SFTLoss",
    "LossOutput",
    "create_loss_strategy",
    "lora_init",
    "merge_lora",
    "export_peft",
    "import_peft",
    "DPODataset",
    "collate",
    "train_val_split",
]
