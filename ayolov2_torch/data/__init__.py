"""Host data: image I/O, validation datasets and the batching loader."""

from ayolov2_torch.data.datasets import DetectionDataset, ImageFolderDataset, letterbox
from ayolov2_torch.data.loader import Batch, DataLoader, collate

__all__ = ["Batch", "DataLoader", "DetectionDataset", "ImageFolderDataset", "collate",
           "letterbox"]
