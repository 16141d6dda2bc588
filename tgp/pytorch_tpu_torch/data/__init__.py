from .batching import ArrayDataset, DataLoader
from .registry import return_dataset
from .kmeans import kmeans_centers
