"""Dataset registry: text-column subsets, dataset ids, canonical
splits, and caption loss weights for the public ProCyon-Instruct layout.

These are schema facts about the released dataset (reference
constants.py:69-709) required for drop-in DATA_DIR compatibility: which
composed description columns each (task, version) reads per text dataset,
the dataset->id mapping used by conflict masks, the canonical split-method
directory per dataset, and the per-dataset caption loss rescales.

Organized task-major; v5 is the released ProCyon-Full configuration.
"""

from typing import List, Optional, Sequence

TEXT_COLUMN_SUBSETS = {'caption': {1: {'disgenet': ['allDescriptions'],
                 'drugbank': ['moa', 'indication'],
                 'drugbank:indication': ['indication'],
                 'drugbank:moa': ['moa'],
                 'ec': [],
                 'go': ['description_name_type_def'],
                 'gtop': ['description_name_overview',
                          'description_name_comments'],
                 'omim': ['description_omim'],
                 'pfam': ['description_pfam', 'description_interpro'],
                 'protein': [None],
                 'reactome': ['description_name_description'],
                 'uniprot': ['function']},
             2: {'disgenet': ['allDescriptions'],
                 'drugbank': ['moa', 'indication'],
                 'drugbank:indication': ['indication'],
                 'drugbank:moa': ['moa'],
                 'ec': ['description_explorenz'],
                 'go': ['go_def'],
                 'gtop': ['description_name_overview',
                          'description_name_comments'],
                 'omim': ['description_omim'],
                 'pfam': ['description_pfam', 'description_interpro'],
                 'protein': [None],
                 'reactome': ['description'],
                 'uniprot': ['function']},
             3: {'disgenet': ['description_all_collapse'],
                 'drugbank': ['moa', 'indication'],
                 'drugbank:indication': ['indication'],
                 'drugbank:moa': ['moa'],
                 'ec': ['description_explorenz'],
                 'go': ['go_def'],
                 'gtop': ['description_name_overview',
                          'description_name_comments'],
                 'omim': ['description_omim'],
                 'pfam': ['description_pfam', 'description_interpro'],
                 'protein': [None],
                 'reactome': ['description'],
                 'uniprot': ['function']},
             4: {'disgenet': ['description_all_collapse'],
                 'drugbank': ['moa', 'indication'],
                 'drugbank:indication': ['indication'],
                 'drugbank:moa': ['moa'],
                 'ec': ['description_explorenz'],
                 'go': ['go_def'],
                 'gtop': ['description_name_overview',
                          'description_name_comments'],
                 'omim': ['description_omim'],
                 'pfam': ['description_pfam', 'description_interpro'],
                 'protein': [None],
                 'reactome': ['description'],
                 'uniprot': ['function']},
             5: {'disgenet': ['description_all_collapse'],
                 'drugbank': ['moa', 'indication'],
                 'drugbank:indication': ['indication'],
                 'drugbank:moa': ['moa'],
                 'ec': ['description_explorenz'],
                 'go': ['go_def'],
                 'gtop': ['target_family_overview', 'target_family_comments'],
                 'omim': ['omim_def_curated',
                          'omim_clinical_curated',
                          'omim_molecular_curated',
                          'omim_title_curated'],
                 'pfam': ['description_pfam', 'description_interpro'],
                 'protein': [None],
                 'reactome': ['description'],
                 'uniprot': ['function']}},
 'qa': {1: {'disgenet': ['description_air',
                         'description_aot',
                         'description_chv',
                         'description_csp',
                         'description_fma',
                         'description_go',
                         'description_hl7v3.0',
                         'description_hpo',
                         'description_lnc',
                         'description_mcm',
                         'description_medlineplus',
                         'description_msh',
                         'description_nci',
                         'description_pdq',
                         'description_spn',
                         'description_uwda',
                         'description_primekg_mondo',
                         'description_primekg_orphanet'],
            'drugbank': ['indication', 'moa'],
            'drugbank:indication': ['indication'],
            'drugbank:moa': ['moa'],
            'ec': ['description_explorenz'],
            'go': ['description_name_type_def'],
            'gtop': ['description_name_overview',
                     'description_name_comments',
                     'description_name_introduction'],
            'omim': ['description_omim',
                     'description_mondo',
                     'description_umls',
                     'description_orphanet',
                     'description_mayo'],
            'pfam': ['description_pfam', 'description_interpro'],
            'protein': [None],
            'reactome': ['description_name_description'],
            'uniprot': ['function']},
        5: {'disgenet': ['description_all_collapse'],
            'drugbank': ['moa', 'indication'],
            'drugbank:indication': ['indication'],
            'drugbank:moa': ['moa'],
            'ec': ['description_explorenz'],
            'go': ['go_def'],
            'gtop': ['target_family_overview', 'target_family_comments'],
            'omim': ['omim_def_curated',
                     'omim_clinical_curated',
                     'omim_molecular_curated',
                     'omim_title_curated'],
            'pfam': ['description_pfam', 'description_interpro'],
            'protein': [None],
            'reactome': ['description'],
            'uniprot': ['function']},
        'ProtLLM': {'disgenet': ['description_all_collapse'],
                    'drugbank': ['indication', 'moa'],
                    'drugbank:indication': ['indication'],
                    'drugbank:moa': ['moa'],
                    'ec': ['description_explorenz'],
                    'go': ['description_name_type_def'],
                    'gtop': ['description_name_overview',
                             'description_name_comments',
                             'description_name_introduction'],
                    'omim': ['description_omim',
                             'description_mondo',
                             'description_umls',
                             'description_orphanet',
                             'description_mayo'],
                    'pfam': ['description_pfam', 'description_interpro'],
                    'protein': [None],
                    'reactome': ['description_name_description'],
                    'uniprot': ['function']},
        'ProtLLM_name': {'disgenet': ['description_all_collapse'],
                         'drugbank': ['indication', 'moa'],
                         'drugbank:indication': ['indication'],
                         'drugbank:moa': ['moa'],
                         'ec': ['explorenz_accepted_name'],
                         'go': ['go_name'],
                         'gtop': ['description_name_overview',
                                  'description_name_comments',
                                  'description_name_introduction'],
                         'omim': ['description_omim',
                                  'description_mondo',
                                  'description_umls',
                                  'description_orphanet',
                                  'description_mayo'],
                         'pfam': ['description_pfam', 'description_interpro'],
                         'protein': [None],
                         'reactome': ['description_name_description'],
                         'uniprot': ['function']}},
 'retrieval': {1: {'disgenet': ['description_air',
                                'description_aot',
                                'description_chv',
                                'description_csp',
                                'description_fma',
                                'description_go',
                                'description_hl7v3.0',
                                'description_hpo',
                                'description_lnc',
                                'description_mcm',
                                'description_medlineplus',
                                'description_msh',
                                'description_nci',
                                'description_pdq',
                                'description_spn',
                                'description_uwda',
                                'description_primekg_mondo',
                                'description_primekg_orphanet'],
                   'drugbank': ['moa', 'indication'],
                   'drugbank:indication': ['indication'],
                   'drugbank:moa': ['moa'],
                   'ec': ['description_explorenz'],
                   'go': ['description_name_type_def'],
                   'gtop': ['description_name_overview',
                            'description_name_comments',
                            'description_name_introduction'],
                   'omim': ['description_omim',
                            'description_mondo',
                            'description_umls',
                            'description_orphanet',
                            'description_mayo'],
                   'pfam': ['description_pfam', 'description_interpro'],
                   'protein': [None],
                   'reactome': ['description_name_description'],
                   'uniprot': ['function']},
               2: {'disgenet': ['description_all_collapse'],
                   'drugbank': ['moa', 'indication'],
                   'drugbank:indication': ['indication'],
                   'drugbank:moa': ['moa'],
                   'ec': ['description_explorenz'],
                   'go': ['description_name_type_def'],
                   'gtop': ['description_name_overview',
                            'description_name_comments',
                            'description_name_introduction'],
                   'omim': ['description_omim',
                            'description_mondo',
                            'description_umls',
                            'description_orphanet',
                            'description_mayo'],
                   'pfam': ['description_pfam', 'description_interpro'],
                   'protein': [None],
                   'reactome': ['description_name_description'],
                   'uniprot': ['function']},
               5: {'disgenet': ['description_all_collapse'],
                   'drugbank': ['moa', 'indication'],
                   'drugbank:indication': ['indication'],
                   'drugbank:moa': ['moa'],
                   'ec': ['description_explorenz'],
                   'go': ['go_def'],
                   'gtop': ['target_family_overview',
                            'target_family_comments'],
                   'omim': ['omim_def_curated',
                            'omim_clinical_curated',
                            'omim_molecular_curated',
                            'omim_title_curated'],
                   'pfam': ['description_pfam', 'description_interpro'],
                   'protein': [None],
                   'reactome': ['description'],
                   'uniprot': ['function']}}}

DATASET_ID = {'disgenet': 2,
 'drugbank': 6,
 'drugbank:indication': 6,
 'drugbank:moa': 6,
 'ec': 8,
 'go': 0,
 'gtop': 7,
 'omim': 5,
 'peptide': 10,
 'pfam': 1,
 'protein': 4,
 'reactome': 3,
 'uniprot': 9}

CANONICAL_SPLITS = {'disgenet': 'area_protein_aware_disgenet_centric',
 'drugbank': 'atc_aware_drugbank_centric',
 'ec': 'hierarchy_aware_ec_centric',
 'go': 'sample_aware_ontology_go_centric',
 'gtop': 'random_gtop_centric',
 'omim': 'disgenet_aligned_improved_omim_centric',
 'pfam': 'clan_aware_pfam_centric',
 'reactome': 'random_reactome_centric',
 'uniprot': 'random_uniprot_centric'}

CAPTION_TRAIN_WEIGHTS = {0: {'domain_go': 0.5,
     'domain_pfam': 2.0,
     'protein_disgenet': 2.0,
     'protein_drugbank': 2.0,
     'protein_drugbank:indication': 2.0,
     'protein_drugbank:moa': 2.0,
     'protein_ec': 2.0,
     'protein_go': 0.5,
     'protein_gtop': 2.0,
     'protein_omim': 2.0,
     'protein_reactome': 1.0,
     'protein_uniprot': 2.0}}

ONTOLOGY_RAG_SUBSETS = {'go': 'description_name_type_def',
 'reactome': 'description_name_description'}

# Named eval-protocol aliases -> per-dataset split names (the paper's
# benchmark protocols). Data contract mirrored from the reference's
# SPLIT_MAPS (procyon/evaluate/framework/constants.py:1-120), resolved at
# dataset-config time like it_data_config.py:269-277. None = the protocol
# does not exist for that dataset (the reference silently substitutes
# None; here resolve_eval_split errors cleanly). Datasets mapped to None
# (protein_protein, protein_gtop, protein_uniprot) have no named eval
# protocols at all.
EVAL_SPLIT_ALIASES = ("pt_ft", "few_shot", "zero_shot", "zero_shot_easy",
                      "zero_shot_hard")

_FIVE_SHOT = {"pt_ft": "eval_pt_ft", "few_shot": "eval_five_shot",
              "zero_shot": "eval_zero_shot", "zero_shot_easy": None,
              "zero_shot_hard": "eval_zero_shot_hard"}
_TWO_SHOT_NO_EASY = {"pt_ft": "eval_pt_ft", "few_shot": "eval_two_shot",
                     "zero_shot": "eval_zero_shot", "zero_shot_easy": None,
                     "zero_shot_hard": "eval_zero_shot_hard"}
_TWO_SHOT_FULL = {"pt_ft": "eval_pt_ft", "few_shot": "eval_two_shot",
                  "zero_shot": "eval_zero_shot",
                  "zero_shot_easy": "eval_zero_shot_easy",
                  "zero_shot_hard": "eval_zero_shot_hard"}

SPLIT_MAPS = {
    "protein_go": dict(_FIVE_SHOT),
    "domain_go": dict(_FIVE_SHOT),
    "domain_pfam": dict(_TWO_SHOT_NO_EASY),
    "protein_disgenet": {**_TWO_SHOT_FULL, "pt_ft": None},
    "protein_reactome": dict(_TWO_SHOT_NO_EASY),
    "protein_protein": None,
    "protein_omim": dict(_TWO_SHOT_FULL),
    "protein_drugbank": dict(_TWO_SHOT_FULL),
    "protein_drugbank:moa": dict(_TWO_SHOT_FULL),
    "protein_drugbank:indication": dict(_TWO_SHOT_FULL),
    "protein_gtop": None,
    "protein_ec": dict(_TWO_SHOT_FULL),
    "protein_uniprot": None,
}


def resolve_eval_split(aaseq_type: str, text_type: str, split: str) -> str:
    """Resolve a named eval protocol (pt_ft / few_shot / zero_shot /
    zero_shot_easy / zero_shot_hard, optionally 'EVAL:'-prefixed like the
    reference's YAML syntax) to the dataset's concrete split name.

    Raw split strings that are not aliases pass through untouched.
    Raises ValueError when the dataset has no SPLIT_MAPS entry or the
    protocol is None for it (the clean-error upgrade over the reference's
    silent None substitution)."""
    alias = split.split(":", 1)[1] if split.startswith("EVAL:") else split
    if alias not in EVAL_SPLIT_ALIASES:
        return split
    dset = f"{aaseq_type}_{text_type}"
    table = SPLIT_MAPS.get(dset, SPLIT_MAPS.get(
        f"{aaseq_type}_{text_type.split(':')[0]}", "missing"))
    if table == "missing":
        raise ValueError(f"dataset name not in SPLIT_MAPS: {dset}")
    if table is None:
        raise ValueError(
            f"dataset {dset} has no named eval protocols (SPLIT_MAPS "
            f"entry is None)")
    resolved = table[alias]
    if resolved is None:
        raise ValueError(
            f"dataset {dset} has no '{alias}' split (SPLIT_MAPS maps it "
            f"to None)")
    return resolved


def column_subset(task: str, text_type: str,
                  version: int = 5) -> Optional[List[str]]:
    """Composed-description columns for (task, dataset, version); None when
    the dataset has no versioned subset (callers fall back to the table's
    default columns)."""
    base = text_type.split(":")[0] if text_type not in \
        TEXT_COLUMN_SUBSETS.get(task, {}).get(version, {}) else text_type
    per_version = TEXT_COLUMN_SUBSETS.get(task, {}).get(version, {})
    cols = per_version.get(text_type, per_version.get(base))
    if cols is None or cols == [None]:
        return None
    return list(cols)


def dataset_id(text_type: str) -> int:
    """Stable dataset id for conflict masks (DATASET_ID semantics)."""
    return DATASET_ID.get(text_type, DATASET_ID.get(
        text_type.split(":")[0], -1))


def canonical_split(text_type: str) -> str:
    base = text_type.split(":")[0]
    return CANONICAL_SPLITS.get(base, "random_split")


def caption_weight(aaseq_type: str, text_type: str, version: int = 0
                   ) -> float:
    return CAPTION_TRAIN_WEIGHTS.get(version, {}).get(
        f"{aaseq_type}_{text_type}", 1.0)
