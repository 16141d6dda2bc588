from .batching import ArrayDataset, DataLoader
from .registry import return_dataset, UCI_REGRESSION, UCI_CLASSIFICATION
from .kmeans import kmeans_centers
