from .pipeline import PrefetchLoader, SyntheticCorpus
