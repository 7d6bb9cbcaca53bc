from .elastic import ElasticConfig, ElasticSpotTrainer

__all__ = ["ElasticSpotTrainer", "ElasticConfig"]
