"""The data-production tools (counterpart of ``vince_tpu/scrape/``), each run as
``python -m vince_tpu_torch.scrape.<tool>``: ``search_youtube_for_urls``,
``cache_video_dataset``, ``recreate_r2v2_dataset``, ``download_kinetics``,
``download_r2v2``, ``download_pretrained_weights``, and ``drive``'s fetches."""
