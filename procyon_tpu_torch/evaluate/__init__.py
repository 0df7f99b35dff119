"""Evaluating ProCyon (counterpart of procyon_tpu/evaluate):
  core.py         run_evaluation orchestration and the model zoo
  retrieval.py    target sets, label matrices, retrieval metrics
  qa.py           yes / no accuracy and macro-F1
  caption.py      ROUGE-L / BLEU (+ BERTScore)
  bertscore.py    BERTScore over models/bert.py
  llm_judge.py    LLM-as-a-judge prompts, verdicts and tallies
  metrics.py      Fmax, top-k P/R, per-query AUROC / AUPRC, bootstrap CIs
  utils.py        metric writing, prediction caching, leak pairs
  data_loading.py DATA_DIR datasets for run_evaluation
  baselines/      kNN, MLP, random and BLAST-matrix comparison models;
                  BioTranslator, ProtST, PubMedBERT / SimCSE, ProtLLM
  procyon_models.py  the ProCyon retrieval, QA and caption wrappers
  quant_quality.py   the quantization gates
"""
